"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``gather_auto``: the AUTO scorer over each query's own candidate ids (fused
row gather). ``fused_auto``: the tiled brute-force AUTO scorer.
``adc_scan``: the brute scan over PQ codes (8-bit and packed 4-bit).
``fm_interaction``: the FM model's second-order term. CPU tensors go to the
plain version in ``ref.py``; CUDA tensors launch the kernel built from
``csrc/`` by ``build.py``, or the call raises. Importing this package
builds nothing: a kernel is compiled on its first CUDA call.
"""
from repro_torch.kernels.adc_scan.ops import adc_scan, adc_scan_topk
from repro_torch.kernels.fused_auto.ops import fused_auto, fused_auto_topk

__all__ = ["adc_scan", "adc_scan_topk", "fused_auto", "fused_auto_topk"]
