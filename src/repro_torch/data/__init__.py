"""Synthetic data, numpy only, with the reference's draws: hybrid datasets
(``synthetic``) and graphs with a fanout sampler (``graph``)."""
