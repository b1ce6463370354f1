"""STABLE hybrid nearest-neighbour search on PyTorch and CUDA (Hopper).

The PyTorch counterpart of ``repro``: the same AUTO metric, HELP graph,
Dynamic Heterogeneity Routing and ``Engine`` facade, with the two scoring
hot spots (``gather_auto``, ``fused_auto``) as hand-written CUDA kernels
built for ``sm_90a``. Every public constructor takes ``device=None``, which
means the CUDA card; pass ``device="cpu"`` to run the kernels' plain
PyTorch versions on the CPU.
"""
