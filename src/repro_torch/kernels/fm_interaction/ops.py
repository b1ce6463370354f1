"""Dispatch for the FM second-order interaction and its gradient.

CPU tensors run the plain versions (``ref.py``); CUDA tensors launch the
hand-written kernels (``kernels/csrc/fm_interaction.cu``) or raise; meta
tensors (``launch.dryrun``) get the result's shape and nothing is counted.
``fm_interaction.launches`` counts forward launches and
``fm_interaction_bwd.launches`` backward ones.

``fm_interaction`` is a ``torch.autograd.Function``: the kernel's result
carries no ``grad_fn`` of its own, and fm's training takes the gradient of
``tables`` through it. Its backward, ∂/∂e_fd = g·(s_d − e_fd) with ``s``
the field sum, is ``fm_interaction_bwd``: on the card one kernel pass that
reads ``emb`` and ``g`` once and writes the gradient once, in the plain
backward's order (``fm_interaction_bwd_ref``), so the card's gradient
equals the CPU's bit for bit. The TPU kernel has no backward (the
reference trains fm through XLA's autodiff of ``fm_interaction_ref``).

Each launch runs a plan made here by ``launch_plan`` from the direction,
the shape, the card's SM count and the base address's alignment, and
handed to the launcher whole: which path (a persistent ring of
shared-memory stages fed by bulk copies, or reads straight from device
memory), the examples a run, the threads a block, the grid and the
stages, the lanes an example and the shared memory a block. The CPU tests
check the plan; the kernels run it as given, and the launcher refuses one
they cannot run.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operands
from repro_torch.kernels.fm_interaction.ref import (
    fm_interaction_bwd_ref,
    fm_interaction_pairwise_ref,
    fm_interaction_ref,
)

_INT_MAX = 2**31 - 1

#: the card's shared memory (H100: 228 KB an SM, 227 KB a block after the
#: launcher's opt-in, 1 KB an SM's runtime keeps for each resident block)
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1_024
#: the stages' mbarriers ahead of the stages (``kBarBytes`` in the source)
BAR_BYTES = 128
#: threads of a staged block, and the most a direct block takes
THREADS = 256
#: the staged ring, forward and backward: (resident blocks an SM, stages a
#: block), the best of ``plan_sweep``'s variants at train_batch on an H100.
#: The backward's stage is stored out from where it was read and refilled
#: one run later, so its ring runs deeper.
RING = {False: (2, 2), True: (2, 4)}
#: below this many runs a block the batch is read straight from memory:
#: there is too little to overlap
MIN_RUNS_PER_BLOCK = 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of either kernel, run by the kernels as given.
    ``examples`` is a run's length: a staged run fills one stage, a direct
    block takes one run a pass of the grid. ``smem`` is a block's dynamic
    shared memory (0 when direct): the stages' barriers, then its stages."""

    path: str  # "staged" or "direct"
    lanes: int  # lanes an example: min(D, 32)
    threads: int
    examples: int
    grid: int
    stages: int
    smem: int

    @property
    def args(self) -> tuple[int, ...]:
        """The launcher's (staged, E, grid, stages, threads, lanes, smem)."""
        return (int(self.path == "staged"), self.examples, self.grid, self.stages, self.threads,
                self.lanes, self.smem)


def _groups(d: int) -> int:
    """Examples a warp: 32 // lanes, with min(D, 32) lanes an example."""
    return 32 // min(d, 32)


def _stage_budget(blocks_per_sm: int) -> int:
    """Bytes of stages a block may hold with ``blocks_per_sm`` resident."""
    return min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks_per_sm - SMEM_RESERVED) - BAR_BYTES


def stage_examples(f: int, d: int, blocks_per_sm: int, stages: int) -> int:
    """The most examples of one stage when ``blocks_per_sm`` blocks of
    ``stages`` stages share an SM: whole passes of a block where one fits,
    else a multiple of 16 bytes; 0 where not even that fits."""
    ex_bytes = 4 * f * d
    per_pass = THREADS // 32 * _groups(d)
    cap = _stage_budget(blocks_per_sm) // stages
    if cap >= per_pass * ex_bytes:
        return cap // (per_pass * ex_bytes) * per_pass
    q = 4 // math.gcd(f * d, 4)
    return cap // ex_bytes // q * q


def staged_plan(b: int, f: int, d: int, sms: int, blocks_per_sm: int, stages: int,
                examples: int) -> Plan:
    """The ring: a grid of at most ``blocks_per_sm`` x ``sms`` persistent
    blocks walking runs of ``examples`` through ``stages`` stages. Raises
    where a run is not a multiple of 16 bytes or the blocks outgrow the
    SM's shared memory."""
    ex_bytes = 4 * f * d
    smem = BAR_BYTES + stages * examples * ex_bytes
    if (min(b, f, d, sms, blocks_per_sm, stages, examples) < 1 or examples * ex_bytes % 16
            or smem - BAR_BYTES > _stage_budget(blocks_per_sm)):
        raise ValueError(f"fm_interaction: B, F, D = {b, f, d} cannot be staged as "
                         f"{blocks_per_sm} blocks an SM x {stages} stages of {examples} examples")
    threads = 32 * min(THREADS // 32, -(-examples // _groups(d)))
    grid = min(-(-b // examples), blocks_per_sm * sms)
    return Plan("staged", min(d, 32), threads, examples, grid, stages, smem)


def direct_plan(b: int, d: int, sms: int) -> Plan:
    """Reads straight from device memory, blocks small enough that the
    grid covers the SMs."""
    warps = max(1, min(THREADS // 32, b // (_groups(d) * sms)))
    run = warps * _groups(d)
    return Plan("direct", min(d, 32), 32 * warps, run, -(-b // run), 0, 0)


@functools.lru_cache(maxsize=1024)  # a pure function of its arguments, on every launch
def launch_plan(b: int, f: int, d: int, sms: int, aligned: bool = True, *,
                backward: bool = False) -> Plan:
    """The plan of the forward (or the ``backward``) for a (B, F, D) batch
    on a card with ``sms`` SMs whose base address is ``aligned`` to 16
    bytes: the ring (``RING``) where the base is aligned, a run of whole
    examples fits a stage and every block gets ``MIN_RUNS_PER_BLOCK``
    runs; otherwise direct."""
    if min(b, f, d, sms) < 1:
        raise ValueError(f"fm_interaction: no plan for B, F, D = {b, f, d} on {sms} SMs")
    blocks_per_sm, stages = RING[backward]
    run = stage_examples(f, d, blocks_per_sm, stages)
    if aligned and run > 0 and b // run >= MIN_RUNS_PER_BLOCK * blocks_per_sm * sms:
        return staged_plan(b, f, d, sms, blocks_per_sm, stages, run)
    return direct_plan(b, d, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(emb: torch.Tensor, backward: bool = False) -> Plan:
    """The plan a CUDA (B, F, D) tensor launches the forward (or the
    backward) with."""
    b, f, d = emb.shape
    return launch_plan(b, f, d, _sm_count(emb.device.index), emb.data_ptr() % 16 == 0,
                       backward=backward)


def _check_shape(name: str, emb: torch.Tensor) -> None:
    if emb.ndim != 3:
        raise ValueError(f"{name}: emb must be (B, F, D), got {tuple(emb.shape)}")
    if max(emb.shape) > _INT_MAX:
        raise ValueError(f"{name}: shape {tuple(emb.shape)} exceeds int32")


def _forward(emb: torch.Tensor) -> torch.Tensor:
    device = check_operands("fm_interaction", emb=emb)
    _check_shape("fm_interaction", emb)
    b, f, d = emb.shape
    if device.type == "cpu":
        return fm_interaction_ref(emb)
    if device.type == "meta":  # the dry run: the result's shape, no work
        return torch.empty((b,), dtype=torch.float32, device=device)
    if device.type != "cuda":
        raise ValueError(f"fm_interaction: unsupported device {device}")
    if b == 0 or f * d == 0:  # nothing to launch: an empty sum is 0
        return torch.zeros((b,), dtype=torch.float32, device=device)
    out = torch.empty((b,), dtype=torch.float32, device=device)
    launch = build.launcher("fm_interaction")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(emb.data_ptr(), out.data_ptr(), b, f, d, *plan_for(emb).args, stream)
    build.check("fm_interaction", rc)
    fm_interaction.launches += 1
    return out


def fm_interaction_bwd(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, F, D) f32 gradient of Σ_b g_b·fm_interaction(emb)_b in ``emb``:
    g_b·(s_bd − e_bfd), ``s`` the field sum. ``g`` is (B,), cast to f32."""
    device = check_operands("fm_interaction_bwd", emb=emb)
    _check_shape("fm_interaction_bwd", emb)
    b, f, d = emb.shape
    if not isinstance(g, torch.Tensor) or tuple(g.shape) != (b,) or g.device != device:
        raise ValueError(f"fm_interaction_bwd: g must be ({b},) on {device}")
    g = g.to(torch.float32).contiguous()
    if device.type == "cpu":
        return fm_interaction_bwd_ref(emb, g)
    if device.type == "meta":  # the dry run: the gradient's shape, no work
        return torch.empty_like(emb)
    if device.type != "cuda":
        raise ValueError(f"fm_interaction_bwd: unsupported device {device}")
    grad = torch.empty_like(emb)
    if b == 0 or f * d == 0:  # an empty gradient
        return grad
    launch = build.launcher("fm_interaction_bwd")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(emb.data_ptr(), g.data_ptr(), grad.data_ptr(), b, f, d,
                    *plan_for(emb, backward=True).args, stream)
    build.check("fm_interaction_bwd", rc)
    fm_interaction_bwd.launches += 1
    return grad


class _FmInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return _forward(emb)

    @staticmethod
    def backward(ctx, g):
        (emb,) = ctx.saved_tensors
        return fm_interaction_bwd(emb, g)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """(B,) f32 FM second-order term ½ Σ_d [(Σ_f e_fd)² − Σ_f e_fd²] of
    (B, F, D) f32 field embeddings, differentiable in ``emb``."""
    return _FmInteraction.apply(emb)


fm_interaction.launches = 0
fm_interaction_bwd.launches = 0

__all__ = [
    "Plan", "direct_plan", "fm_interaction", "fm_interaction_bwd", "fm_interaction_bwd_ref",
    "fm_interaction_pairwise_ref", "fm_interaction_ref", "launch_plan", "plan_for",
    "stage_examples", "staged_plan",
]
