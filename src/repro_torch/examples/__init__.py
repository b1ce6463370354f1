"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(``quickstart``, ``serve_hybrid``, ``subset_query``, ``train_retrieval``),
each on the CUDA card unless ``--device cpu`` is passed."""
