"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(``quickstart``, ``serve_hybrid``, ``subset_query``), each on the CUDA card
unless ``--device cpu`` is passed."""
