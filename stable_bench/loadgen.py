"""The traffic generator: reads a mix from ``traffic/<name>.json`` and
turns the configuration's queries into the program's compiled batches.

A mix names its driver (``drivers/<driver>.py``: how calls are grouped,
sized and sent), the backend and search parameters of every call, and a
list of predicate classes. Query i of the configuration's query set
belongs to class ``i % len(classes)`` (the port's ``serve_queries``
shape). A class is ``{"name", "default", "attrs": {str(l): template}}``;
a template is ``"match"`` (the query's own label), ``"any"``,
``["one_of", o, ...]`` (the labels (a + o) mod labels) or
``["between", lo, hi]``.

Each group of queries the driver names is compiled by the program once,
in set-up (``QueryBatch.from_queries``), and a call takes its rows from
that compiled batch (``QueryBatch.take``).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def predicate(api, template, label: int, labels: int):
    """The program's predicate object for one attribute of one query."""
    if template == "match":
        return api.MATCH(label)
    if template == "any":
        return api.ANY
    if template[0] == "between":
        return api.BETWEEN(int(template[1]), int(template[2]))
    if template[0] == "one_of":
        return api.ONE_OF(*[(label + int(o)) % labels for o in template[1:]])
    raise ValueError(f"unknown predicate template {template!r}")


def group_batches(api, classes: list, qf: np.ndarray, qa: np.ndarray, labels: int,
                  group_rows: list) -> list:
    """One compiled ``QueryBatch`` per group, over all of its queries."""
    tmpl = [[c.get("attrs", {}).get(str(j), c["default"]) for j in range(qa.shape[1])]
            for c in classes]

    def query(i):
        t = tmpl[i % len(classes)]
        return api.Query(qf[i], [predicate(api, tj, int(a), labels) for tj, a in zip(t, qa[i])])

    return [api.QueryBatch.from_queries([query(i) for i in rows]) for rows in group_rows]
