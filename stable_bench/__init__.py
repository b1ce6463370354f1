"""The benchmark of the PyTorch and CUDA port (``repro_torch``): hybrid
search cells driven through ``Engine.search``, judged by a plain PyTorch
reference. Run a cell with ``python3 stable_bench/run.py``."""
