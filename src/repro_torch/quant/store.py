"""Quantized vector store: codec selection, training, persistence.

``QuantizedVectors`` owns what a codec needs at search time (codes plus
dequantization parameters or codebooks) and hands routing its operand tuple
(``routing_operand``). Codec family:

* ``sq8``: per-dimension scalar quantization, M bytes per row (int8).
* ``pq``: product quantization, K = 256, S bytes per row (uint8).
* ``pq4``: 4-bit PQ, K = 16, two codes per byte, ⌈S/2⌉ bytes per row.
* ``opq-pq`` / ``opq-pq4``: the same after a learned orthogonal rotation
  (OPQ), applied at encode time and inside the query LUT (``lut``) only.

Persistence matches the reference byte for byte: the same ``quant_*.npy``
files and the same meta block, with a versioned ``codec`` spec, so each
package loads the other's store.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import resolve_device, to_tensor
from repro_torch.quant.opq import opq_train, rotate
from repro_torch.quant.pq import PQCodebook, adc_lut, pack_nibbles, pq_encode, pq_train
from repro_torch.quant.sq import SQParams, sq8_encode

Tensor = torch.Tensor

#: codec modes shared by RoutingConfig.quant_mode and SearchParams.quant.
QUANT_MODES = ("none", "sq8", "pq", "pq4", "opq-pq", "opq-pq4")

#: every mode that scores through ADC tables over PQ codes.
PQ_MODES = ("pq", "pq4", "opq-pq", "opq-pq4")

#: newest quant meta ``codec.version`` this reader understands.
#: v1 = sq8 / unpacked 8-bit pq; v2 adds packed 4-bit codes + OPQ rotation.
CODEC_VERSION = 2

#: array files of a saved store, by the key ``quant_from_numpy`` reads.
FILES = {
    "codes": "quant_codes.npy",
    "sq_scale": "quant_sq_scale.npy",
    "sq_zero": "quant_sq_zero.npy",
    "centroids": "quant_centroids.npy",
    "rotation": "quant_rotation.npy",
}


def is_pq_mode(mode: str) -> bool:
    """True for every PQ-family codec (plain, packed, rotated)."""
    return mode in PQ_MODES


def pq_bits(mode: str) -> int:
    """Code width in bits for a PQ-family mode (8 or 4)."""
    return 4 if mode.endswith("4") else 8


def is_packed_mode(mode: str) -> bool:
    """True when codes are stored two per byte (4-bit family)."""
    return is_pq_mode(mode) and pq_bits(mode) == 4


def has_rotation(mode: str) -> bool:
    """True when the codec carries a learned OPQ rotation."""
    return mode.startswith("opq")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "none"
    pq_subspaces: int = 8
    pq_centroids: int = 256
    pq_train_iters: int = 15
    pq_train_samples: int = 16384
    seed: int = 0
    opq_iters: int = 6  # OPQ alternating-minimization rounds (opq-* modes)
    anisotropic: float = 0.0  # magnitude-weighted loss toward score direction

    def __post_init__(self):
        if self.mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {self.mode!r} (have {QUANT_MODES})")

    @property
    def effective_centroids(self) -> int:
        """K for the PQ codebook: 4-bit modes force K = 16 (one nibble)."""
        return 16 if is_packed_mode(self.mode) else self.pq_centroids


@dataclasses.dataclass
class QuantizedVectors:
    """Codes + codec state for one database; ``None`` stands for mode='none'."""

    cfg: QuantConfig
    codes: Tensor  # sq8: (N, M) int8 · pq: (N, S) u8 · pq4: (N, ⌈S/2⌉) u8 packed
    sq_params: Optional[SQParams] = None
    codebook: Optional[PQCodebook] = None
    rotation: Optional[Tensor] = None  # (Mp, Mp) orthogonal, opq-* only

    @classmethod
    def build(cls, features, cfg: QuantConfig, device=None) -> Optional["QuantizedVectors"]:
        """Train the configured codec over the database; None for mode
        'none'. Runs on ``device``: None means the device of a ``features``
        tensor, else the CUDA card."""
        if cfg.mode == "none":
            return None
        if device is None and isinstance(features, Tensor):
            device = features.device
        features = to_tensor(features, torch.float32, resolve_device(device))
        if cfg.mode == "sq8":
            codes, params = sq8_encode(features)
            return cls(cfg=cfg, codes=codes, sq_params=params)
        rotation = None
        if has_rotation(cfg.mode):
            rotation, codebook = opq_train(
                features, n_subspaces=cfg.pq_subspaces, n_centroids=cfg.effective_centroids,
                n_iters=cfg.pq_train_iters, opq_iters=cfg.opq_iters,
                n_samples=cfg.pq_train_samples, seed=cfg.seed, anisotropic=cfg.anisotropic,
            )
            features = rotate(features, rotation)
        else:
            codebook = pq_train(
                features, n_subspaces=cfg.pq_subspaces, n_centroids=cfg.effective_centroids,
                n_iters=cfg.pq_train_iters, n_samples=cfg.pq_train_samples, seed=cfg.seed,
            )
        codes = pq_encode(features, codebook)
        if is_packed_mode(cfg.mode):
            codes = pack_nibbles(codes)
        return cls(cfg=cfg, codes=codes, codebook=codebook, rotation=rotation)

    # -- codec-aware views ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def packed(self) -> bool:
        return is_packed_mode(self.cfg.mode)

    def lut(self, qv: Tensor) -> Tensor:
        """Per-query ADC tables (B, S, K); the OPQ rotation is applied here,
        so every consumer (kernel, gather path) stays rotation-oblivious."""
        if self.rotation is not None:
            qv = rotate(qv, self.rotation)
        return adc_lut(qv, self.codebook)

    def encode_rows(self, features) -> Tensor:
        """Encode rows with the frozen codec state (params, rotation and
        codebooks from build time), in the layout and dtype of ``codes``."""
        features = to_tensor(features, torch.float32, self.device)
        if self.cfg.mode == "sq8":
            return sq8_encode(features, self.sq_params)[0]
        if self.rotation is not None:
            features = rotate(features, self.rotation)
        rows = pq_encode(features, self.codebook)
        return pack_nibbles(rows) if self.packed else rows

    def routing_operand(self, qv: Tensor) -> tuple[Tensor, ...]:
        """The operand tuple of ``routing.search`` (query-dependent for PQ:
        the per-query ADC tables are built here)."""
        if self.cfg.mode == "sq8":
            return (self.codes, self.sq_params.scale, self.sq_params.zero)
        return (self.codes, self.lut(qv))

    @property
    def code_bytes(self) -> int:
        return int(self.codes.numel() * self.codes.element_size())

    @property
    def code_bytes_per_row(self) -> int:
        """Device bytes of one encoded row (sq8: M · pq: S · pq4: ⌈S/2⌉)."""
        return int(self.codes.shape[1] * self.codes.element_size())

    # -- persistence (rides on StableIndex.save/load) ------------------------

    def save(self, path: str) -> dict:
        """Write the code and codec arrays under ``path``; returns the meta
        block that goes into meta.json."""
        arrays = {"codes": self.codes}
        if self.sq_params is not None:
            arrays.update(sq_scale=self.sq_params.scale, sq_zero=self.sq_params.zero)
        if self.codebook is not None:
            arrays["centroids"] = self.codebook.centroids
        if self.rotation is not None:
            arrays["rotation"] = self.rotation
        for key, arr in arrays.items():
            np.save(os.path.join(path, FILES[key]), arr.cpu().numpy())
        return {"cfg": dataclasses.asdict(self.cfg),
                "dim": self.codebook.dim if self.codebook else None,
                "codec": codec_spec(self.cfg)}

    @classmethod
    def load(cls, path: str, meta: dict, mmap: bool = False, device=None) -> "QuantizedVectors":
        """Read a store (either package's) onto ``device`` (None → the CUDA
        card)."""
        mode = QuantConfig(**meta["cfg"]).mode
        keys = ["codes"]
        if mode == "sq8":
            keys += ["sq_scale", "sq_zero"]
        else:
            keys += ["centroids"] + (["rotation"] if has_rotation(mode) else [])
        arrays = {
            k: np.load(os.path.join(path, FILES[k]), mmap_mode="r" if mmap and k == "codes" else None)
            for k in keys
        }
        return quant_from_numpy(meta, arrays, device)


def quant_from_numpy(meta: dict, arrays: dict, device=None) -> QuantizedVectors:
    """A port store from a saved store's meta block (``cfg``, ``dim``,
    ``codec``) and its arrays as numpy, keyed as in ``FILES`` (``codes``,
    ``sq_scale``, ``sq_zero``, ``centroids``, ``rotation``), placed on
    ``device`` (None → the CUDA card). Codes keep their dtype: int8 for
    sq8, uint8 for the PQ family."""
    cfg = QuantConfig(**meta["cfg"])
    check_codec_spec(meta.get("codec"), cfg)
    dev = resolve_device(device)
    codes_np = np.asarray(arrays["codes"])
    want = np.int8 if cfg.mode == "sq8" else np.uint8
    if codes_np.dtype != want:
        raise ValueError(f"quant codes are {codes_np.dtype}, mode {cfg.mode!r} stores {np.dtype(want)}")
    codes = to_tensor(codes_np, torch.int8 if cfg.mode == "sq8" else torch.uint8, dev)

    def f32(key):
        return to_tensor(arrays[key], torch.float32, dev)

    if cfg.mode == "sq8":
        return QuantizedVectors(cfg=cfg, codes=codes,
                                sq_params=SQParams(scale=f32("sq_scale"), zero=f32("sq_zero")))
    return QuantizedVectors(
        cfg=cfg, codes=codes,
        codebook=PQCodebook(centroids=f32("centroids"), dim=int(meta["dim"])),
        rotation=f32("rotation") if has_rotation(cfg.mode) else None,
    )


# ---------------------------------------------------------------------------
# versioned codec spec: one meta block shared by every save format
# ---------------------------------------------------------------------------


def codec_spec(cfg: QuantConfig) -> dict:
    """The versioned codec descriptor recorded next to saved codec state."""
    bits = pq_bits(cfg.mode) if is_pq_mode(cfg.mode) else 8
    v2 = is_packed_mode(cfg.mode) or has_rotation(cfg.mode)
    return {
        "version": CODEC_VERSION if v2 else 1,
        "bits": bits,
        "rotation": has_rotation(cfg.mode),
    }


def check_codec_spec(codec: Optional[dict], cfg: QuantConfig) -> None:
    """Reject stores written by a newer codec than this reader understands,
    and stores whose codec block disagrees with their config (corruption)."""
    if codec is None:  # pre-versioning store: plain sq8/pq only
        if is_packed_mode(cfg.mode) or has_rotation(cfg.mode):
            raise ValueError(
                f"quant store in mode {cfg.mode!r} has no codec spec block: "
                "written by an incompatible build; re-save the index"
            )
        return
    version = int(codec.get("version", 1))
    if version > CODEC_VERSION:
        raise ValueError(
            f"quant store codec version {version} is newer than this reader "
            f"(supports ≤ {CODEC_VERSION}); upgrade before loading"
        )
    expect = codec_spec(cfg)
    if (int(codec.get("bits", 8)) != expect["bits"]
            or bool(codec.get("rotation", False)) != expect["rotation"]):
        raise ValueError(
            f"quant store codec block {codec!r} does not match configured "
            f"mode {cfg.mode!r} (expected {expect!r}): the store is corrupt or "
            "was rewritten by a mismatched build"
        )
