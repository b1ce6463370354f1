"""Closed loop, one caller: calls of ``Engine.search`` back to back.

A mix with ``"driver": "closed_loop"`` states:

``calls``  ``"by_class"``: call j is a batch of queries all of class
           ``j % len(classes)``, taken in order from that class's queries
           and cycling through them. ``"whole_set"``: every call takes its
           queries in order from the whole query set, all classes mixed.
``batch``  queries a call, or ``"all"``: every query of the call's group
           (with ``"whole_set"``, the whole query set in one call, as
           ANN-benchmarks' batch mode hands it to a search engine). A call
           of ``"all"`` takes them in an order of its own, a permutation
           drawn from the call's index: every call does the same work, and
           no answer of an earlier call can pass for its own.

Each call's latency runs from the call to its ids and scores on the host.
"""
from __future__ import annotations

import time

import numpy as np

KEYS = {"driver", "calls", "batch", "params", "classes"}


def groups(mix: dict, n_queries: int) -> list[tuple[str, np.ndarray]]:
    """(name, query ids) of each group that calls take their rows from."""
    if set(mix) != KEYS:
        raise ValueError(f"a closed_loop mix has the keys {sorted(KEYS)}, not {sorted(mix)}")
    classes = mix["classes"]
    if mix["calls"] == "whole_set":
        return [("whole_set", np.arange(n_queries))]
    if mix["calls"] != "by_class":
        raise ValueError(f"unknown grouping of calls {mix['calls']!r}")
    return [(c["name"], np.arange(i, n_queries, len(classes))) for i, c in enumerate(classes)]


def call_rows(j: int, batch, rows: list[np.ndarray]) -> tuple[int, np.ndarray]:
    """(group, positions within that group's queries) of call j."""
    c = j % len(rows)
    n = len(rows[c])
    if batch == "all":
        return c, np.random.default_rng(j).permutation(n)
    start = (j // len(rows)) * int(batch)
    return c, (start + np.arange(int(batch))) % n


def warm_up(prog) -> None:
    """One call of each group: every shape the window uses."""
    for j in range(len(prog.groups)):
        prog.call(*call_rows(j, prog.mix["batch"], prog.rows))


def window(prog, seconds: float, span, counters: bool, min_calls: int = 1) -> list[dict]:
    """The calls of one window of ``seconds`` (at least ``min_calls``), each
    inside ``span(name)``."""
    calls = []
    t0 = time.perf_counter()
    j = 0
    while j < min_calls or time.perf_counter() - t0 < seconds:
        c, pos = call_rows(j, prog.mix["batch"], prog.rows)
        with span(f"search.{prog.groups[c][0]}"):
            calls.append(prog.call(c, pos, counters))
        j += 1
    return calls
