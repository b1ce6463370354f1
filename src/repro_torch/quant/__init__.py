"""Quantized search: compressed-code scanning + exact rerank.

A quantized index scores compressed codes to fill an oversized candidate
pool, then reranks the pool head at full precision: a bounded recall loss
for far fewer full-precision evaluations and bytes read.

Codecs
------
``sq8``  int8 per-dimension affine scalar quantization (4× smaller).
         Gathered codes decode and go through the exact fused-AUTO math.
``pq``   product quantization, S subspaces × 256 centroids; S bytes a row.
         Distances come from asymmetric distance computation (ADC): a
         per-query (S, 256) table of partial squared distances, S lookups
         and adds per row.
``pq4``  4-bit PQ, K = 16, two codes per byte (⌈S/2⌉ bytes a row).
``opq-pq`` / ``opq-pq4``  a learned orthogonal rotation (OPQ) before the
         subspace split; it lives in the encode and the query LUT only.

Layers
------
* ``sq`` / ``pq`` / ``opq``: codec math (train, encode, decode, LUT).
* ``store.QuantizedVectors``: codes + codec state + persistence.
* ``kernels/adc_scan``: the hand-written ``adc_scan`` / ``adc_scan4`` CUDA
  kernels that scan every code with the AUTO penalty fused (brute backend).
* ``core/routing``: traversal over codes and the exact rerank of the pool
  head (``n_dist_evals`` counts the rerank, ``n_code_evals`` the codes).

    from repro_torch.api import Engine, QueryBatch, SearchParams
    from repro_torch.quant import QuantConfig

    eng = Engine.build(features, attrs, quant_cfg=QuantConfig(mode="pq"))
    res = eng.search(QueryBatch.match(qv, qa), SearchParams(k=10))
"""
from repro_torch.kernels.adc_scan.ops import adc_scan, adc_scan_topk
from repro_torch.quant.opq import opq_reconstruct, opq_train, rotate
from repro_torch.quant.pq import (
    PQCodebook, adc_gathered_sqdist, adc_lut, pack_nibbles, pq_decode,
    pq_encode, pq_train, unpack_nibbles,
)
from repro_torch.quant.sq import SQParams, sq8_decode, sq8_encode, sq8_train
from repro_torch.quant.store import (
    CODEC_VERSION, PQ_MODES, QUANT_MODES, QuantConfig, QuantizedVectors,
    codec_spec, has_rotation, is_packed_mode, is_pq_mode, pq_bits,
    quant_from_numpy,
)

__all__ = [
    "CODEC_VERSION",
    "PQ_MODES",
    "QUANT_MODES",
    "QuantConfig",
    "QuantizedVectors",
    "PQCodebook",
    "SQParams",
    "adc_gathered_sqdist",
    "adc_lut",
    "adc_scan",
    "adc_scan_topk",
    "codec_spec",
    "has_rotation",
    "is_packed_mode",
    "is_pq_mode",
    "opq_reconstruct",
    "opq_train",
    "pack_nibbles",
    "pq_bits",
    "pq_decode",
    "pq_encode",
    "pq_train",
    "quant_from_numpy",
    "rotate",
    "sq8_decode",
    "sq8_encode",
    "sq8_train",
    "unpack_nibbles",
]
