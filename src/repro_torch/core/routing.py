"""Dynamic Heterogeneity Routing (paper §III-D, Alg. 3), batched.

Coarse phase: the pioneer set P = R[:P] of the sorted result pool expands
only the first ⌈Γ/2⌉ neighbours of each unchecked pioneer, until no
iteration improves P. Fine phase: greedy refinement expands the full
neighbour list of every unchecked pool entry until the pool is checked.

A whole query batch advances in lock-step iterations; all unchecked
pioneers of a query expand in one iteration; insertion sort is a dedup
merge plus a stable sort (``graph_ops.merge_pools``); a (B, N) visited map
suppresses re-scoring. Every candidate block is scored by the
``gather_auto`` kernel straight from the row table.

Where the reference runs ``lax.while_loop``, this module runs a Python
loop: the stop tests (``active.any()`` in the coarse stage, "any pool entry
unchecked" in the refine stage) each cost one device-to-host read per hop.

Spans (``repro_torch.obs.trace``): ``seed`` (``init_state``), ``coarse``
and ``refine`` (attribute ``hops``), ``hop`` around each expansion (it
holds no device wait: its length is the host's issue of the hop),
``stop_test`` around each loop test that reads the device (attribute
``active``: the rows the next hop works for, read in the same single
read), and ``emit``.

Quantized traversal (``quant_mode`` ∈ sq8, pq, pq4, opq-pq, opq-pq4)
scores candidates from codes only: sq8 codes decode after the gather,
PQ-family codes sum the per-query ADC tables (4-bit codes unpack after the
gather; the OPQ rotation lives in the tables). Both stay plain torch on the
card, as they are plain jnp in the reference. The pool head
(``rerank_size``) is then re-scored exactly through ``gather_auto``.
``n_dist_evals`` counts only the exact evaluations, ``n_code_evals`` the
code ones.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import auto as auto_mod
from repro_torch.core import graph_ops as gops
from repro_torch.core import resolve_device, to_tensor
from repro_torch.core.auto import MetricConfig
from repro_torch.core.graph_ops import INF, INVALID
from repro_torch.kernels.gather_auto.ops import gather_auto
from repro_torch.obs import trace as obs_trace
from repro_torch.quant import pq as pq_mod
from repro_torch.quant import sq as sq_mod
from repro_torch.quant.store import QUANT_MODES, is_packed_mode

Tensor = torch.Tensor

#: Incremented once per compiled search plan (``api.executor``): the port's
#: counterpart of the reference's jit trace count. Tests assert that
#: plan-cache hits add nothing here.
_TRACE_COUNT = [0]


def trace_count() -> int:
    """Total search plans compiled so far in this process."""
    return _TRACE_COUNT[0]


def note_compiled_plan() -> None:
    _TRACE_COUNT[0] += 1


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    k: int = 10  # K: results returned
    pool_size: int = 64  # |R| ≥ K
    pioneer_size: int = 8  # P
    coarse_max_iters: int = 64
    refine_max_iters: int = 256
    use_visited: bool = True  # (B, N) scored-map
    enforce_equality: bool = False  # final hard filter (off: paper behaviour)
    quant_mode: str = "none"  # traversal scoring codec
    rerank_size: int = 0  # pool entries re-scored exactly (0 → pool_size)
    coarse_fixed: bool = False  # "w/o Dynamic" ablation: fixed coarse budget

    def __post_init__(self):
        if self.k > self.pool_size:
            raise ValueError("k must be ≤ pool_size")
        if self.pioneer_size > self.pool_size:
            raise ValueError("pioneer_size must be ≤ pool_size")
        if self.quant_mode not in QUANT_MODES:
            raise ValueError(f"unknown quant_mode {self.quant_mode!r}")
        if self.rerank_size:
            if not (self.k <= self.rerank_size <= self.pool_size):
                raise ValueError("need k ≤ rerank_size ≤ pool_size")

    @property
    def effective_rerank(self) -> int:
        return self.rerank_size or self.pool_size


class SearchResult(NamedTuple):
    ids: Tensor  # (B, K) node ids (INVALID-padded), int32
    dists: Tensor  # (B, K) fused distances U (sqrt applied)
    sqdists: Tensor  # (B, K) squared fused metric (ranking scale)
    n_dist_evals: Tensor  # (B,) full-precision distance evaluations per query
    n_hops: Tensor  # () total expansion iterations executed
    n_code_evals: Tensor | int = 0  # (B,) compressed-code evaluations

    @property
    def total_dist_evals(self) -> int:
        return int(np.sum(_host(self.n_dist_evals)))

    @property
    def total_code_evals(self) -> int:
        return int(np.sum(_host(self.n_code_evals)))

    @property
    def mean_dist_evals(self) -> float:
        return self.total_dist_evals / max(self.ids.shape[0], 1)

    @property
    def mean_code_evals(self) -> float:
        return self.total_code_evals / max(self.ids.shape[0], 1)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _score_candidates(
    db_v: Tensor,
    db_a: Tensor,
    cand: Tensor,  # (B, C) node ids (INVALID allowed)
    qv: Tensor,
    qa: Tensor,
    metric_cfg: MetricConfig,
    mask: Optional[Tensor],
    quant: tuple = (),
    quant_mode: str = "none",
) -> Tensor:
    """(B, C) squared fused distances of each query to its own candidates;
    INF on INVALID slots. ``qa`` is (B, L) points or (B, L, 2) intervals.
    ``quant`` is the store's ``routing_operand``: (codes, scale, zero) for
    sq8, (codes, lut) for the PQ family. Attributes are never quantized."""
    if quant_mode == "none" and metric_cfg.mode in ("auto", "l2"):
        return gather_auto(
            qv, qa, db_v, db_a, cand, alpha=metric_cfg.alpha,
            mode=metric_cfg.mode, mask=mask,
        )
    m = mask[:, None, :] if mask is not None else None
    ca = gops.gather_rows(db_a, cand)
    if quant_mode == "none":
        sv2 = gather_auto(qv, qa, db_v, db_a, cand, mode="l2")
    elif quant_mode == "sq8":
        codes, scale, zero = quant
        cv = sq_mod.sq8_decode(gops.gather_rows(codes, cand), sq_mod.SQParams(scale, zero))
        sv2 = auto_mod.feature_sqdist(qv[:, None, :], cv)
    else:
        # ADC: Σ_s lut[b, s, code] stands in for the f32 feature term
        codes, lut = quant
        cc = gops.gather_rows(codes, cand)  # (B, C, S), or (B, C, ⌈S/2⌉) packed
        if is_packed_mode(quant_mode):
            cc = pq_mod.unpack_nibbles(cc, lut.shape[1])
        sv2 = torch.clamp_min(pq_mod.adc_gathered_sqdist(lut, cc), 0.0)
    d = auto_mod.fused_sqdist_from_sv2(sv2, qa[:, None], ca, metric_cfg, m)
    return d.masked_fill(cand < 0, INF)


class _State(NamedTuple):
    r_ids: Tensor  # (B, R) int32, sorted ascending by dist
    r_d: Tensor  # (B, R) f32
    checked: Tensor  # (B, R) int8
    visited: Tensor  # (B, N + 1) int8 (column N absorbs INVALID) or (B, 1)
    active: Tensor  # (B,) bool: rows still making progress
    evals: Tensor  # (B,) int32 per-query counter
    hops: int
    it: int


def _expand(
    state: _State,
    db_v: Tensor,
    db_a: Tensor,
    graph: Tensor,
    qv: Tensor,
    qa: Tensor,
    metric_cfg: MetricConfig,
    mask: Optional[Tensor],
    scope: int,  # entries of R eligible for expansion (P or pool_size)
    fanout: int,  # neighbours taken per expanded entry (Γ/2 or Γ)
    watch: int,  # improvement watched over R[:watch]
    use_visited: bool,
    quant: tuple = (),
    quant_mode: str = "none",
    force_active: bool = False,  # expand regardless of the dynamic-exit flag
) -> _State:
    """One expansion iteration. Updates ``state.visited`` in place (the
    (B, N) map is the largest tensor of a search; the old state is never
    read again)."""
    b, pool = state.r_ids.shape

    # --- choose expansion entries: all unchecked among R[:scope] -----------
    head = state.r_ids[:, :scope]
    elig = (state.checked[:, :scope] == 0) & (head >= 0)
    if not force_active:
        elig = elig & state.active[:, None]
    exp_ids = torch.where(elig, head, INVALID)  # (B, scope)

    # --- gather neighbour candidates ----------------------------------------
    nbrs = gops.gather_rows(graph, exp_ids)[:, :, :fanout]  # (B, scope, fanout)
    cand = nbrs.reshape(b, scope * fanout)
    dead = (exp_ids < 0)[:, :, None].expand(b, scope, fanout).reshape(b, -1)
    cand = cand.masked_fill(dead, INVALID)
    visited = state.visited
    if use_visited:
        seen = visited.gather(1, cand.clamp_min(0).long()).to(torch.bool)
        cand = cand.masked_fill(seen, INVALID)

    # --- score ----------------------------------------------------------------
    cd = _score_candidates(db_v, db_a, cand, qv, qa, metric_cfg, mask, quant, quant_mode)
    n_new_evals = (cand >= 0).sum(1, dtype=torch.int32)

    # --- bookkeeping: expanded entries become checked; candidates visited --
    checked = state.checked.clone()
    checked[:, :scope] = torch.maximum(checked[:, :scope], elig.to(torch.int8))
    if use_visited:
        n_col = visited.shape[1] - 1  # INVALID candidates land in the spare column
        visited.scatter_(1, torch.where(cand >= 0, cand, n_col).long(), 1)

    # --- merge ----------------------------------------------------------------
    old_watch = state.r_ids[:, :watch]
    r_ids, r_d, checked = gops.merge_pools(
        state.r_ids, state.r_d, cand, cd, pool,
        pool_flags=checked, cand_flags=torch.zeros_like(cand, dtype=torch.int8),
    )
    checked = checked.masked_fill(r_ids < 0, 1)  # pads never expand
    improved = (r_ids[:, :watch] != old_watch).any(1)
    still_unchecked = ((checked[:, :scope] == 0) & (r_ids[:, :scope] >= 0)).any(1)
    return _State(
        r_ids=r_ids,
        r_d=r_d,
        checked=checked,
        visited=visited,
        active=state.active & (improved | still_unchecked),
        evals=state.evals + n_new_evals,
        hops=state.hops + 1,
        it=state.it + 1,
    )


# ---------------------------------------------------------------------------
# Composable stages
# ---------------------------------------------------------------------------


def init_state(
    db_v: Tensor,
    db_a: Tensor,
    qv: Tensor,
    qa: Tensor,
    entry_ids: Tensor,  # (B, pool) initial pool node ids
    metric_cfg: MetricConfig,
    cfg: RoutingConfig,
    n_nodes: int,
    mask: Optional[Tensor] = None,
    quant: tuple = (),
) -> _State:
    """Stage 1 (Alg. 3 init): score the random-K seed pool, sorted
    ascending, with the visited map primed on the seeds."""
    b = qv.shape[0]
    pool = cfg.pool_size
    dev = qv.device
    d0 = _score_candidates(
        db_v, db_a, entry_ids, qv, qa, metric_cfg, mask, quant, cfg.quant_mode
    )
    r_ids, r_d, _ = gops.merge_pools(
        torch.full((b, pool), INVALID, dtype=torch.int32, device=dev),
        torch.full((b, pool), INF, dtype=torch.float32, device=dev),
        entry_ids, d0, pool,
    )
    checked = (r_ids < 0).to(torch.int8)
    if cfg.use_visited:
        visited = torch.zeros((b, n_nodes + 1), dtype=torch.int8, device=dev)
        visited.scatter_(1, entry_ids.clamp_min(0).long(), 1)
    else:
        visited = torch.zeros((b, 1), dtype=torch.int8, device=dev)
    return _State(
        r_ids=r_ids, r_d=r_d, checked=checked, visited=visited,
        active=torch.ones((b,), dtype=torch.bool, device=dev),
        evals=(entry_ids >= 0).sum(1, dtype=torch.int32),
        hops=0,
        it=0,
    )


def _rows_left(work: Tensor, sp) -> bool:
    """A loop's stop test: whether any row of ``work`` ((B,) or (B, W)
    bool) is still true, in one device-to-host read. On a recorded stage
    span ``sp`` the same read takes the count of such rows, kept as the
    ``stop_test`` span's ``active``."""
    if not sp:
        return bool(work.any())
    with obs_trace.span("stop_test") as st:
        rows = work.any(1) if work.dim() > 1 else work
        active = int(rows.sum())
        st.set("active", active)
    return active > 0


def coarse_stage(
    state: _State,
    db_v: Tensor,
    db_a: Tensor,
    graph: Tensor,
    qv: Tensor,
    qa: Tensor,
    metric_cfg: MetricConfig,
    cfg: RoutingConfig,
    mask: Optional[Tensor] = None,
    quant: tuple = (),
) -> _State:
    """Stage 2, Dynamic Coarse Routing: pioneer set = R[:P], half-fanout
    expansion until no iteration improves P (or, with ``cfg.coarse_fixed``,
    for exactly ``coarse_max_iters`` iterations)."""
    half = max(1, graph.shape[1] // 2)
    with obs_trace.span("coarse") as sp:
        hops0 = state.hops
        while state.it < cfg.coarse_max_iters and (
            cfg.coarse_fixed or _rows_left(state.active, sp)
        ):
            with obs_trace.span("hop"):
                state = _expand(
                    state, db_v, db_a, graph, qv, qa, metric_cfg, mask,
                    scope=cfg.pioneer_size, fanout=half, watch=cfg.pioneer_size,
                    use_visited=cfg.use_visited, quant=quant, quant_mode=cfg.quant_mode,
                    force_active=cfg.coarse_fixed,
                )
        if sp:
            sp.set("hops", state.hops - hops0)
    return state


def refine_stage(
    state: _State,
    db_v: Tensor,
    db_a: Tensor,
    graph: Tensor,
    qv: Tensor,
    qa: Tensor,
    metric_cfg: MetricConfig,
    cfg: RoutingConfig,
    mask: Optional[Tensor] = None,
    quant: tuple = (),
) -> _State:
    """Stage 3, Greedy Refinement Routing: full pool, full fanout, until
    the pool is fully checked."""
    with obs_trace.span("refine") as sp:
        state = state._replace(active=torch.ones_like(state.active), it=0)
        hops0 = state.hops
        while state.it < cfg.refine_max_iters and _rows_left(
            (state.checked == 0) & (state.r_ids >= 0), sp
        ):
            with obs_trace.span("hop"):
                state = _expand(
                    state, db_v, db_a, graph, qv, qa, metric_cfg, mask,
                    scope=cfg.pool_size, fanout=graph.shape[1], watch=cfg.pool_size,
                    use_visited=cfg.use_visited, quant=quant, quant_mode=cfg.quant_mode,
                )
        if sp:
            sp.set("hops", state.hops - hops0)
    return state


def traverse_pool(
    db_v: Tensor,
    db_a: Tensor,
    graph: Tensor,
    qv: Tensor,
    qa: Tensor,
    entry_ids: Tensor,
    metric_cfg: MetricConfig,
    cfg: RoutingConfig,
    n_nodes: int,
    mask: Optional[Tensor] = None,
    quant: tuple = (),
) -> _State:
    """Stages 1–3: seed + coarse + refine, returning the final pool state
    (sorted ascending by the traversal codec's distance)."""
    with obs_trace.span("seed"):
        state = init_state(db_v, db_a, qv, qa, entry_ids, metric_cfg, cfg, n_nodes, mask, quant)
    state = coarse_stage(state, db_v, db_a, graph, qv, qa, metric_cfg, cfg, mask, quant)
    return refine_stage(state, db_v, db_a, graph, qv, qa, metric_cfg, cfg, mask, quant)


def score_exact(
    db_v: Tensor,
    db_a: Tensor,
    ids: Tensor,  # (B, C), INVALID allowed
    qv: Tensor,
    qa: Tensor,
    metric_cfg: MetricConfig,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """(B, C) exact fused sqdists for gathered candidates (INF on INVALID)."""
    return _score_candidates(db_v, db_a, ids.contiguous(), qv, qa, metric_cfg, mask)


def enforce_filter(
    out_ids: Tensor,
    out_sq: Tensor,
    db_a: Tensor,
    qa: Tensor,
    mask: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """Hard predicate filter on emitted ids: equality for point targets,
    [lo, hi] containment for interval targets; masked-out dims pass."""
    oa = gops.gather_rows(db_a, out_ids)
    if qa.ndim == 3:
        okl = (oa >= qa[:, None, :, 0]) & (oa <= qa[:, None, :, 1])
    else:
        okl = oa == qa[:, None, :]
    if mask is not None:
        okl = okl | (mask[:, None, :] == 0)
    ok = okl.all(-1)
    return out_ids.masked_fill(~ok, INVALID), out_sq.masked_fill(~ok, INF)


def emit_topk(
    state: _State,
    db_v: Tensor,
    db_a: Tensor,
    qv: Tensor,
    qa: Tensor,
    metric_cfg: MetricConfig,
    cfg: RoutingConfig,
    mask: Optional[Tensor] = None,
) -> SearchResult:
    """Stage 4: exact traversal emits the pool head; a quantized one
    re-scores the first ``rerank_size`` pool entries exactly (the only
    full-precision evaluations of its search) and emits their top k.
    Either is optionally hard-filtered."""
    b = state.r_ids.shape[0]
    dev = state.r_ids.device
    with obs_trace.span("emit"):
        if cfg.quant_mode != "none":
            r_ids = state.r_ids[:, : cfg.effective_rerank]
            rd = score_exact(db_v, db_a, r_ids, qv, qa, metric_cfg, mask)
            return _emit_reranked(rd, r_ids, db_a, qa, cfg, mask, state.evals, state.hops)
        return _emit(
            state.r_ids[:, : cfg.k], state.r_d[:, : cfg.k], db_a, qa, cfg, mask,
            n_dist_evals=state.evals,
            n_code_evals=torch.zeros((b,), dtype=torch.int32, device=dev),
            hops=state.hops,
        )


def _emit_reranked(
    rd: Tensor,  # (B, R) exact fused sqdists of the pool head (INF on INVALID)
    r_ids: Tensor,  # (B, R) pool-head ids
    db_a: Tensor,
    qa: Tensor,
    cfg: RoutingConfig,
    mask: Optional[Tensor],
    evals: Optional[Tensor],
    hops: int,
) -> SearchResult:
    """The quantized tail of stage 4: the top k of the re-scored head."""
    out_sq, take = gops.smallest_k(rd, cfg.k)
    out_ids = torch.where(out_sq < INF / 2, r_ids.gather(1, take), INVALID)
    if evals is None:
        evals = torch.zeros((r_ids.shape[0],), dtype=torch.int32, device=r_ids.device)
    return _emit(
        out_ids, out_sq, db_a, qa, cfg, mask,
        n_dist_evals=(r_ids >= 0).sum(1, dtype=torch.int32), n_code_evals=evals, hops=hops,
    )


def _emit(out_ids, out_sq, db_a, qa, cfg, mask, n_dist_evals, n_code_evals, hops) -> SearchResult:
    """The emitted top k, hard-filtered under ``enforce_equality``."""
    if cfg.enforce_equality:
        out_ids, out_sq = enforce_filter(out_ids, out_sq, db_a, qa, mask)
    return SearchResult(
        ids=out_ids,
        dists=torch.sqrt(torch.clamp_min(out_sq, 0.0)),
        sqdists=out_sq,
        n_dist_evals=n_dist_evals,
        n_hops=torch.tensor(int(hops), dtype=torch.int32, device=out_ids.device),
        n_code_evals=n_code_evals,
    )


def search_pool(
    db_a: Tensor,
    graph: Tensor,
    qv: Tensor,
    qa: Tensor,
    entry_ids: Tensor,
    metric_cfg: MetricConfig,
    cfg: RoutingConfig,
    n_nodes: int,
    mask: Optional[Tensor] = None,
    quant: tuple = (),
) -> tuple[Tensor, Tensor, int]:
    """Stages 1–3 only, for callers that source the rerank rows themselves
    (the hot/cold tier in ``repro_torch.cache``): traverse over compressed
    codes and return ``(r_ids, evals, hops)``, ``r_ids`` the pool head
    trimmed to ``cfg.effective_rerank``.

    A quantized traversal never reads the f32 rows (the codes carry the
    feature term, see ``_score_candidates``), so none are taken; a (1, M)
    dummy fills the stages' row-table operand."""
    if cfg.quant_mode == "none":
        raise ValueError("search_pool requires a quantized traversal codec")
    dummy_v = torch.zeros((1, qv.shape[1]), dtype=torch.float32, device=qv.device)
    state = traverse_pool(
        dummy_v, db_a, graph, qv, qa, entry_ids, metric_cfg, cfg, n_nodes, mask, quant
    )
    return state.r_ids[:, : cfg.effective_rerank], state.evals, state.hops


def staged_operands(cv: Tensor, db_a: Tensor, r_ids: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The operands that score pre-gathered rows through ``gather_auto``:
    ``cv`` (B, R, M) viewed as a (B·R, M) row table, the rows' attributes
    gathered into a (B·R, L) table beside it, and ids ``arange(B·R)`` in
    the (B, R) layout of ``r_ids`` with INVALID kept where ``r_ids < 0``.
    Each (b, r) pair then reads the same values at the same (b, c) place
    as a gather from the full table would, so the kernel returns the same
    bits."""
    b, r = r_ids.shape
    ca = gops.gather_rows(db_a, r_ids).reshape(b * r, db_a.shape[1])
    ids = torch.arange(b * r, dtype=torch.int32, device=r_ids.device).view(b, r)
    ids = torch.where(r_ids < 0, INVALID, ids)
    return cv.reshape(b * r, cv.shape[-1]).contiguous(), ca, ids


def rerank_gathered(
    cv: Tensor,  # (B, R, M) candidate f32 rows, pre-gathered (INVALID → row 0)
    db_a: Tensor,
    r_ids: Tensor,  # (B, R) pool-head ids (INVALID-padded)
    qv: Tensor,
    qa: Tensor,
    metric_cfg: MetricConfig,
    cfg: RoutingConfig,
    mask: Optional[Tensor] = None,
    evals: Optional[Tensor] = None,
    hops: int = 0,
) -> SearchResult:
    """Stage 4 for pre-gathered candidates: ``emit_topk``'s quantized
    branch with the f32 gather replaced by the caller's ``cv`` (the tier
    takes hot rows from a device slice and cold rows from the host store,
    ``repro_torch.cache.HotTier``). The rows are scored by the same
    ``gather_auto`` call ``score_exact`` makes (``staged_operands``), so
    rows equal to ``idx.features[r_ids]`` give bit-identical ids and
    distances."""
    v_tab, a_tab, ids = staged_operands(cv, db_a, r_ids)
    rd = score_exact(v_tab, a_tab, ids, qv, qa, metric_cfg, mask)
    return _emit_reranked(rd, r_ids, db_a, qa, cfg, mask, evals, hops)


def make_entry_ids(
    n_nodes: int, batch: int, pool_size: int, seed: int = 0, device=None
) -> Tensor:
    """Alg. 3 init: random-K seed nodes, shared across the batch.

    The draw depends only on (n_nodes, pool_size, seed), byte for byte the
    reference's numpy draw: every row gets the same seed pool, so a query's
    result does not depend on its row or on the batch it is served in.
    """
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_nodes, size=(1, pool_size), dtype=np.int32)
    return torch.from_numpy(row).to(resolve_device(device)).expand(batch, pool_size).contiguous()


def search(
    db_v: Tensor,
    db_a: Tensor,
    graph: Tensor,
    qv,
    qa,
    metric_cfg: MetricConfig,
    cfg: RoutingConfig = RoutingConfig(),
    mask=None,
    entry_ids: Optional[Tensor] = None,
    seed: int = 0,
    quant=None,  # Optional[repro_torch.quant.QuantizedVectors]
) -> SearchResult:
    """Batched hybrid ANNS over a HELP index, on the device that holds the
    index. ``qa`` carries (B, L) points or (B, L, 2) [lo, hi] intervals;
    host arrays are moved to that device. A ``QuantizedVectors`` store runs
    the traversal over its codes with an exact rerank (``quant_mode`` comes
    from the store when ``cfg`` leaves it at 'none')."""
    dev = db_v.device
    qv = to_tensor(qv, torch.float32, dev)
    qa = to_tensor(qa, torch.int32, dev)
    mask = None if mask is None else to_tensor(mask, torch.int32, dev)
    n = db_v.shape[0]
    if entry_ids is None:
        entry_ids = make_entry_ids(n, qv.shape[0], cfg.pool_size, seed, device=dev)
    operand: tuple = ()
    if quant is not None:
        if cfg.quant_mode == "none":
            cfg = dataclasses.replace(cfg, quant_mode=quant.cfg.mode)
        elif cfg.quant_mode != quant.cfg.mode:
            raise ValueError(
                f"cfg.quant_mode={cfg.quant_mode!r} != store mode {quant.cfg.mode!r}"
            )
        operand = quant.routing_operand(qv)
    elif cfg.quant_mode != "none":
        raise ValueError(f"quant_mode={cfg.quant_mode!r} needs a quant store")
    state = traverse_pool(
        db_v, db_a, graph, qv, qa, entry_ids, metric_cfg, cfg, n, mask, operand
    )
    return emit_topk(state, db_v, db_a, qv, qa, metric_cfg, cfg, mask)


# ---------------------------------------------------------------------------
# Ablation: the "w/o DCR" and "w/o Dynamic" routing variants (paper Fig. 6)
# ---------------------------------------------------------------------------


def search_greedy_only(
    db_v, db_a, graph, qv, qa, metric_cfg,
    cfg: RoutingConfig = RoutingConfig(), mask=None, entry_ids=None, seed: int = 0,
):
    """'w/o DCR': skip the coarse phase, plain greedy refinement."""
    c = dataclasses.replace(cfg, coarse_max_iters=0)
    return search(db_v, db_a, graph, qv, qa, metric_cfg, c, mask, entry_ids, seed)


def search_two_stage(
    db_v, db_a, graph, qv, qa, metric_cfg,
    cfg: RoutingConfig = RoutingConfig(), mask=None, entry_ids=None, seed: int = 0,
):
    """'w/o Dynamic': NHQ-style fixed two-stage routing; the coarse stage
    runs to a fixed iteration budget, then refinement."""
    c = dataclasses.replace(
        cfg, pioneer_size=max(cfg.pool_size // 2, 1), coarse_fixed=True
    )
    return search(db_v, db_a, graph, qv, qa, metric_cfg, c, mask, entry_ids, seed)
