"""STABLE hybrid nearest-neighbour search on PyTorch and CUDA (Hopper).

The PyTorch counterpart of ``repro``: the same AUTO metric, HELP graph,
Dynamic Heterogeneity Routing and ``Engine`` facade, the codecs, and the
recsys models' serve, retrieval and train steps, with every hot spot
(``gather_auto``, ``fused_auto``, ``adc_scan``, ``adc_scan4``,
``fm_interaction``) a hand-written CUDA kernel built for ``sm_90a``. Every public constructor takes ``device=None``, which
means the CUDA card; pass ``device="cpu"`` to run the kernels' plain
PyTorch versions on the CPU.
"""
