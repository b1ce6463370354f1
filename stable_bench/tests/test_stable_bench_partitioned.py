"""The harness's build step opened to the program's partitioned index: a
configuration whose ``index`` names a ``partition`` builds through
``Engine.build_partitioned`` and runs end to end; a flat one builds through
``Engine.build`` as before; ``check.promises`` follows what the partitioned
searcher enforces."""
import time

import numpy as np
import pytest

from repro_torch import api
from repro_torch.core.help_graph import HelpConfig
from stable_bench import bench, check
from stable_bench.tests.helpers import CPU, SMALL_PARTITION, manifest, small_cell

M = manifest()
FLAT = [c["name"] for c in M["configs"]]


class Built(Exception):
    """Raised by a recording build, so that nothing is built."""


def _recorder(calls, name):
    def record(*args, **kw):
        calls.append((name, args, kw))
        raise Built
    return record


def _host_arrays():
    rng = np.random.default_rng(0)
    return rng.normal(size=(16, 4)).astype(np.float32), rng.integers(0, 3, (16, 3))


@pytest.mark.parametrize("config", FLAT)
def test_flat_configuration_builds_as_before(config, monkeypatch):
    """Each flat configuration of the manifest reaches ``Engine.build`` with
    the host arrays, its ``HelpConfig``, no codec and the device, and
    nothing else."""
    conf = next(c for c in M["configs"] if c["name"] == config)
    cfg = bench.load_json(bench.ROOT / conf["file"])
    calls = []
    monkeypatch.setattr(api.Engine, "build", _recorder(calls, "build"))
    monkeypatch.setattr(api.Engine, "build_partitioned", _recorder(calls, "build_partitioned"))
    features, attrs = _host_arrays()
    with pytest.raises(Built):
        bench.build_engine(api, cfg, features, attrs, CPU)
    assert len(calls) == 1
    name, args, kw = calls[0]
    assert name == "build"
    assert len(args) == 2 and args[0] is features and args[1] is attrs
    assert kw == {"help_cfg": HelpConfig(**cfg["index"]["help"]), "quant_cfg": None, "device": CPU}


def test_partitioned_configuration_builds_partitioned(monkeypatch):
    cfg = small_cell("partitioned.brute").config
    calls = []
    monkeypatch.setattr(api.Engine, "build", _recorder(calls, "build"))
    monkeypatch.setattr(api.Engine, "build_partitioned", _recorder(calls, "build_partitioned"))
    features, attrs = _host_arrays()
    with pytest.raises(Built):
        bench.build_engine(api, cfg, features, attrs, CPU)
    name, args, kw = calls[0]
    assert name == "build_partitioned" and len(calls) == 1
    assert args[0] is features and args[1] is attrs and args[2] == SMALL_PARTITION["n_partitions"]
    assert kw == {"help_cfg": HelpConfig(), "quant_cfg": None, "device": CPU,
                  "residency_rows": SMALL_PARTITION["residency_rows"],
                  "kmeans_iters": SMALL_PARTITION["kmeans_iters"]}


FLAT_INDEX = {"help": {}, "quant": None}
PQ = {"mode": "pq", "pq_subspaces": 8}


def _part(p):
    return dict(FLAT_INDEX, partition={"n_partitions": p})


#: (search params, index, exact, hard_all); a partitioned plan as
#: ``PartitionedSearcher.search`` enforces it: a scan enforces every
#: predicate, a traversal only under ``enforce_equality``; exact only for a
#: scan of every partition over full-precision rows
PROMISES = [
    ({"backend": "brute"}, FLAT_INDEX, True, True),
    ({"backend": "graph"}, FLAT_INDEX, False, False),
    ({"backend": "graph", "enforce_equality": True}, FLAT_INDEX, False, True),
    ({"backend": "brute"}, dict(FLAT_INDEX, quant=PQ), False, True),
    ({"backend": "partitioned", "sub_backend": "brute", "nprobe": 8}, _part(8), True, True),
    ({"backend": "partitioned", "sub_backend": "brute", "nprobe": 9}, _part(8), True, True),
    ({"backend": "partitioned", "sub_backend": "brute", "nprobe": 7}, _part(8), False, True),
    ({"backend": "partitioned", "sub_backend": "brute", "nprobe": 8},
     dict(_part(8), quant=PQ), False, True),
    ({"backend": "partitioned", "sub_backend": "brute", "nprobe": 8},
     dict(_part(8), quant={"mode": "none"}), True, True),
    ({"backend": "partitioned", "sub_backend": "graph", "nprobe": 8}, _part(8), False, False),
    ({"backend": "partitioned", "sub_backend": "graph", "nprobe": 3, "enforce_equality": True},
     _part(8), False, True),
]


@pytest.mark.parametrize("params,index,exact,hard_all", PROMISES)
def test_promises(params, index, exact, hard_all):
    assert check.promises(dict(params, k=10), index) == {"exact": exact, "hard_all": hard_all}


@pytest.fixture(scope="module")
def built():
    """The engines the partitioned runs below built, by sub-backend."""
    return {}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["partitioned.brute", "partitioned.graph"])
def test_partitioned_cell_runs_end_to_end(name, trace, built, monkeypatch):
    """A small partitioned cell, under a cap below its rows, runs through
    ``bench.run_cell`` with each sub-backend, traced and not, and reads
    ``correct``."""
    cell = small_cell(name)
    build = api.Engine.build_partitioned

    def keep(*args, **kw):
        eng = build(*args, **kw)
        built[(name, trace)] = eng.index
        return eng

    monkeypatch.setattr(api.Engine, "build_partitioned", keep)
    out = bench.run_cell(cell, 2**31 + 11 + trace, 0.3, bool(trace), CPU, api, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out.pop("malformed_by") == {} and out["failed"] == 0 and out["attempted"] > 0
    assert "exact_gap" not in out["checks"]
    # a scan of some partitions owes every admitted row it reached, up to k
    assert ("short_share" in out["checks"]) == (name == "partitioned.brute")
    index = built[(name, trace)]
    assert index.n_partitions == SMALL_PARTITION["n_partitions"]
    store = index.store.stats()
    assert store["cap_rows"] == SMALL_PARTITION["residency_rows"] < cell.config["n_rows"]
    assert store["evictions"] > 0
    if trace:
        assert {"executor.plan_hit_rate.exact", "build.build_s"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"qps.exact", "p95_ms", "setup_s"}
