"""Declarative hybrid queries (paper §III-E: "one index, every query class").

A hybrid query is a feature vector plus one predicate per attribute
dimension:

  ``MATCH(v)``        — the attribute must equal the mapped value ``v``
                        (full-equality query; compiles to mask = 1).
  ``ANY``             — wildcard / missing value (subset query; compiles to
                        mask = 0 so the dimension drops out of Eq. 8).
  ``ONE_OF(v1, …)``   — the attribute must take one of several values.
                        Compiles to the covering interval [min vⱼ, max vⱼ]
                        for traversal (the interval-gap AUTO penalty is a
                        lower bound of min_j |a − v_j|, zero across the
                        hull), and exact set membership is enforced on every
                        backend's output — unlike MATCH, whose hard
                        filtering is opt-in via ``enforce_equality``.
  ``BETWEEN(lo, hi)`` — range predicate: the attribute should fall inside
                        [lo, hi]. The AUTO penalty is the interval gap
                        max(lo − a, a − hi, 0); like MATCH it stays a soft
                        penalty under traversal unless ``enforce_equality``
                        (the brute oracle always hard-filters).

``Query`` is a single request; ``QueryBatch`` is the compiled, array-form
batch the ``Engine`` executes. Compilation produces exactly the (qa, mask)
pair the legacy ``search(..., mask=...)`` keyword path consumed whenever
every predicate is point-like (MATCH/ANY/single-value sets), so the
declarative surface is bit-compatible with hand-built masks: an all-MATCH
batch compiles to ``mask=None`` (the pure full-equality fast path) and an
all-ANY batch is pure unfiltered ANN. Wide predicates (multi-value ONE_OF,
BETWEEN with lo < hi) additionally compile an ``intervals`` (B, L, 2)
array — the per-dimension [lo, hi] targets every scorer consumes natively
(see ``core.auto``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

__all__ = [
    "ANY",
    "BETWEEN",
    "MATCH",
    "ONE_OF",
    "Predicate",
    "Query",
    "QueryBatch",
]


@dataclasses.dataclass(frozen=True)
class Predicate:
    """One per-attribute constraint.
    ``kind`` ∈ {match, any, one_of, between}."""

    kind: str
    values: tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in ("match", "any", "one_of", "between"):
            raise ValueError(f"unknown predicate kind {self.kind!r}")
        if self.kind == "match" and len(self.values) != 1:
            raise ValueError("MATCH takes exactly one value")
        if self.kind == "one_of" and not self.values:
            raise ValueError("ONE_OF needs at least one value")
        if self.kind == "any" and self.values:
            raise ValueError("ANY takes no values")
        if self.kind == "between":
            if len(self.values) != 2:
                raise ValueError("BETWEEN takes exactly (lo, hi)")
            if self.values[0] > self.values[1]:
                raise ValueError(
                    f"BETWEEN needs lo ≤ hi, got {self.values}"
                )

    # -- compilation ---------------------------------------------------------

    @property
    def interval(self) -> tuple[int, int]:
        """[lo, hi] traversal target steering the interval AUTO penalty.

        MATCH: [v, v]. ONE_OF: the covering hull [min vⱼ, max vⱼ].
        BETWEEN: [lo, hi] verbatim. ANY: [0, 0] (ignored, the mask zeroes
        the dimension).
        """
        if self.kind == "any":
            return (0, 0)
        if self.kind == "between":
            return (int(self.values[0]), int(self.values[1]))
        return (int(min(self.values)), int(max(self.values)))

    @property
    def target(self) -> int:
        """Legacy point target (interval midpoint, ties toward the smaller
        admissible value). Only consumed when the whole batch is point-like;
        wide predicates are scored from ``interval`` instead."""
        if self.kind == "any":
            return 0
        if self.kind == "match":
            return int(self.values[0])
        lo, hi = self.interval
        mid = (lo + hi) / 2.0
        if self.kind == "one_of":
            return int(min(sorted(self.values), key=lambda v: abs(v - mid)))
        return int(mid)

    @property
    def active(self) -> bool:
        return self.kind != "any"

    @property
    def is_point(self) -> bool:
        """True iff the interval is degenerate (lo == hi) — the predicate
        compiles onto the legacy point-target path bit-exactly."""
        lo, hi = self.interval
        return lo == hi

    def admits(self, value: int) -> bool:
        if self.kind == "any":
            return True
        if self.kind == "one_of":
            return int(value) in self.values
        lo, hi = self.interval
        return lo <= int(value) <= hi


def MATCH(value: int) -> Predicate:
    return Predicate("match", (int(value),))


def ONE_OF(*values: int) -> Predicate:
    flat: list[int] = []
    for v in values:  # accept ONE_OF(1, 2) and ONE_OF([1, 2])
        if isinstance(v, (list, tuple, np.ndarray)):
            flat.extend(int(x) for x in v)
        else:
            flat.append(int(v))
    return Predicate("one_of", tuple(sorted(set(flat))))


def BETWEEN(lo: int, hi: int) -> Predicate:
    return Predicate("between", (int(lo), int(hi)))


ANY = Predicate("any")


@dataclasses.dataclass(frozen=True)
class Query:
    """One declarative hybrid request: vector + per-attribute predicates."""

    vector: np.ndarray
    predicates: tuple[Predicate, ...]

    def __init__(self, vector, predicates: Sequence[Predicate]):
        object.__setattr__(
            self, "vector", np.asarray(vector, np.float32).reshape(-1)
        )
        preds = tuple(predicates)
        if not all(isinstance(p, Predicate) for p in preds):
            raise TypeError(
                "predicates must be MATCH/ANY/ONE_OF/BETWEEN instances"
            )
        object.__setattr__(self, "predicates", preds)

    @property
    def attr_dim(self) -> int:
        return len(self.predicates)


class QueryBatch:
    """Compiled batch form of B queries over L attribute dimensions.

    Arrays (host numpy; the Engine converts on dispatch):
      vectors   (B, M) f32   query features
      attrs     (B, L) i32   legacy point targets (Predicate.target)
      mask      (B, L) i32 or None — Eq. 8 active-dimension mask; None iff
                every predicate is active (bit-compatible with the legacy
                no-mask full-equality path)
      intervals (B, L, 2) i32 or None — per-dimension [lo, hi] scorer
                targets; None iff every predicate is point-like (lo = hi),
                which keeps the legacy point path bit-exact. When present,
                ``targets`` returns it and every backend scores intervals.
      allowed   (B, L, V) i32, -1 padded — exact admissible value sets of
                the ONE_OF dimensions (membership is enforced on every
                backend); None when no multi-valued ONE_OF predicate exists
      hard      (B, L) bool — True exactly on ONE_OF dimensions; None with
                allowed
    """

    __slots__ = ("vectors", "attrs", "mask", "allowed", "hard", "intervals")

    def __init__(
        self,
        vectors: np.ndarray,
        attrs: np.ndarray,
        mask: Optional[np.ndarray] = None,
        allowed: Optional[np.ndarray] = None,
        hard: Optional[np.ndarray] = None,
        intervals: Optional[np.ndarray] = None,
    ):
        self.vectors = np.asarray(vectors, np.float32)
        self.attrs = np.asarray(attrs, np.int32)
        if self.vectors.ndim != 2 or self.attrs.ndim != 2:
            raise ValueError("vectors must be (B, M) and attrs (B, L)")
        if self.vectors.shape[0] != self.attrs.shape[0]:
            raise ValueError("vectors/attrs batch sizes differ")
        self.mask = None if mask is None else np.asarray(mask, np.int32)
        if self.mask is not None and self.mask.shape != self.attrs.shape:
            raise ValueError("mask must have the same (B, L) shape as attrs")
        self.intervals = (
            None if intervals is None else np.asarray(intervals, np.int32)
        )
        if self.intervals is not None:
            if self.intervals.shape != self.attrs.shape + (2,):
                raise ValueError("intervals must be (B, L, 2)")
            if (self.intervals[..., 0] > self.intervals[..., 1]).any():
                raise ValueError("intervals need lo ≤ hi per dimension")
        self.allowed = None if allowed is None else np.asarray(allowed, np.int32)
        if self.allowed is not None and self.allowed.shape[:2] != self.attrs.shape:
            raise ValueError("allowed must be (B, L, V)")
        if (allowed is None) != (hard is None):
            raise ValueError("allowed and hard come together")
        self.hard = None if hard is None else np.asarray(hard, bool)
        if self.hard is not None and self.hard.shape != self.attrs.shape:
            raise ValueError("hard must have the same (B, L) shape as attrs")

    # -- constructors --------------------------------------------------------

    @classmethod
    def match(
        cls,
        vectors,
        attrs,
        active: Optional[Sequence[int]] = None,
    ) -> "QueryBatch":
        """Full-equality batch from plain arrays; ``active`` (attribute
        column indices) turns every other dimension into ANY (subset
        query). ``active=None`` → all dimensions constrained (mask-free)."""
        vectors = np.asarray(vectors, np.float32)
        attrs = np.asarray(attrs, np.int32)
        if active is None:
            return cls(vectors, attrs)
        mask = np.zeros_like(attrs, np.int32)
        mask[:, list(active)] = 1
        return cls(vectors, attrs, mask=mask)

    @classmethod
    def pure_ann(cls, vectors, attr_dim: int) -> "QueryBatch":
        """Unfiltered ANN batch: every attribute dimension is ANY."""
        vectors = np.asarray(vectors, np.float32)
        b = vectors.shape[0]
        attrs = np.zeros((b, attr_dim), np.int32)
        return cls(vectors, attrs, mask=np.zeros((b, attr_dim), np.int32))

    @classmethod
    def from_queries(cls, queries: Sequence[Query]) -> "QueryBatch":
        """Stack declarative ``Query`` objects into the compiled batch."""
        if not queries:
            raise ValueError("empty query batch")
        l = queries[0].attr_dim
        if any(q.attr_dim != l for q in queries):
            raise ValueError("all queries must share the attribute dim")
        vectors = np.stack([q.vector for q in queries])
        attrs = np.array(
            [[p.target for p in q.predicates] for q in queries], np.int32
        )
        mask = np.array(
            [[int(p.active) for p in q.predicates] for q in queries], np.int32
        )
        ivs = np.array(
            [[p.interval for p in q.predicates] for q in queries], np.int32
        )  # (B, L, 2)
        if (ivs[..., 0] == ivs[..., 1]).all():
            ivs = None  # all point-like ≡ the legacy (attrs, mask) path
        has_one_of = any(
            p.kind == "one_of" for q in queries for p in q.predicates
        )
        allowed = hard = None
        if has_one_of:
            v = max(
                len(p.values) for q in queries for p in q.predicates
                if p.kind == "one_of"
            )
            allowed = np.full((len(queries), l, v), -1, np.int32)
            hard = np.zeros((len(queries), l), bool)
            for i, q in enumerate(queries):
                for j, p in enumerate(q.predicates):
                    if p.kind == "one_of":
                        allowed[i, j, : len(p.values)] = p.values
                        hard[i, j] = True
        if mask.all():
            mask = None  # all-active ≡ the legacy mask-free path
        return cls(
            vectors, attrs, mask=mask, allowed=allowed, hard=hard,
            intervals=ivs,
        )

    # -- views ---------------------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self.vectors.shape[0]

    @property
    def attr_dim(self) -> int:
        return self.attrs.shape[1]

    @property
    def targets(self) -> np.ndarray:
        """The scorer's attribute-target operand: (B, L, 2) intervals when
        any predicate is wide, the legacy (B, L) points otherwise."""
        return self.attrs if self.intervals is None else self.intervals

    @property
    def has_wildcard(self) -> bool:
        return self.mask is not None and bool((self.mask == 0).any())

    @property
    def has_one_of(self) -> bool:
        return self.allowed is not None

    @property
    def has_intervals(self) -> bool:
        return self.intervals is not None

    @property
    def is_pure_ann(self) -> bool:
        """All-wildcard batch ≡ unfiltered ANN (mask zeroes out Eq. 8)."""
        return self.mask is not None and bool((self.mask == 0).all())

    def _bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) per dimension — degenerate [attrs, attrs] for point
        batches so containment checks cover every predicate uniformly."""
        if self.intervals is not None:
            return self.intervals[..., 0], self.intervals[..., 1]
        return self.attrs, self.attrs

    def admissible(self, db_attrs: np.ndarray) -> np.ndarray:
        """(B, N) bool: rows of ``db_attrs`` satisfying every predicate.

        This is the exact hard-filter semantics: MATCH is equality, ANY is
        always-true, BETWEEN is interval containment, ONE_OF is set
        membership. Used by the brute-force oracle backend and the
        engine-level ``enforce_equality`` filter.
        """
        xa = np.asarray(db_attrs)
        lo, hi = self._bounds()
        okl = (xa[None, :, :] >= lo[:, None, :]) & (
            xa[None, :, :] <= hi[:, None, :]
        )  # (B, N, L)
        if self.allowed is not None:
            # exact membership in the padded ONE_OF sets: (B, N, L, V)
            member = (
                xa[None, :, :, None] == self.allowed[:, None, :, :]
            ).any(-1)
            okl = okl & (member | ~self.hard[:, None, :])
        if self.mask is not None:
            okl = okl | (self.mask[:, None, :] == 0)
        return okl.all(-1)

    def admissible_rows(
        self, cand_attrs: np.ndarray, one_of_only: bool = False
    ) -> np.ndarray:
        """(B, K) bool for *per-query* candidate attribute rows (B, K, L) —
        the O(B·K·L·V) form the engine uses to hard-filter traversal
        output (``admissible`` broadcasts one shared database instead).

        ``one_of_only=True`` constrains just the multi-valued (true ONE_OF)
        dimensions: ONE_OF membership is exact on every backend, while
        MATCH/BETWEEN stay a soft AUTO penalty unless ``enforce_equality``.
        """
        xa = np.asarray(cand_attrs)
        if one_of_only:
            if self.allowed is None:
                return np.ones(xa.shape[:2], bool)
            member = (xa[..., None] == self.allowed[:, None, :, :]).any(-1)
            return (member | ~self.hard[:, None, :]).all(-1)
        lo, hi = self._bounds()
        okl = (xa >= lo[:, None, :]) & (xa <= hi[:, None, :])
        if self.allowed is not None:
            member = (xa[..., None] == self.allowed[:, None, :, :]).any(-1)
            okl = okl & (member | ~self.hard[:, None, :])
        if self.mask is not None:
            okl = okl | (self.mask[:, None, :] == 0)
        return okl.all(-1)

    def take(self, idx) -> "QueryBatch":
        """Row-gathered sub-batch (all per-query arrays sliced together).

        ``idx`` may repeat rows — the partitioned searcher pads per-partition
        query groups up to a bucket size by repeating a real query index, so
        the padded rows share a compiled shape without perturbing results.
        """
        idx = np.asarray(idx, np.int64)

        def sel(a):
            return None if a is None else a[idx]

        return QueryBatch(
            self.vectors[idx], self.attrs[idx], mask=sel(self.mask),
            allowed=sel(self.allowed), hard=sel(self.hard),
            intervals=sel(self.intervals),
        )

    def __repr__(self) -> str:
        kinds = "point" if self.intervals is None else "interval"
        if self.allowed is not None:
            kinds += "+one-of"
        m = "none" if self.mask is None else "per-dim"
        return (
            f"QueryBatch(B={self.batch_size}, L={self.attr_dim}, "
            f"{kinds}, mask={m})"
        )
