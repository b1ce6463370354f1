"""The partitioned (IVF) deployment in the manifest: its configuration, mix,
limits and per-layer metrics found by name, and the build step each
configuration reaches."""
import numpy as np
import pytest

from repro_torch import api
from repro_torch.core.help_graph import HelpConfig
from stable_bench import bench, check, loadgen
from stable_bench.tests.helpers import CPU, manifest
from stable_bench.tests.test_stable_bench_partition_spans import IVF, READERS

M = manifest()
CONFIG = "sift1m-theta243-ivf128"
FLAT_SIBLING = "sift1m-theta243"


def config_body(name):
    conf = next(c for c in M["configs"] if c["name"] == name)
    return bench.load_json(bench.ROOT / conf["file"])


FLAT = [c["name"] for c in M["configs"] if config_body(c["name"])["index"].get("partition") is None]


def test_the_cell_is_found_by_name():
    cell = bench.Cell(M, IVF)
    assert cell.workload["config"] == CONFIG and cell.workload["traffic"] == "bulk_ivf"
    assert cell.workload["chips"] == 1
    assert cell.mix["params"] == {"k": 10, "pool_size": 40, "backend": "partitioned",
                                  "nprobe": 11, "sub_backend": "brute"}
    assert cell.mix["calls"] == "by_class" and cell.mix["batch"] == 128
    assert cell.mix["classes"] == loadgen.load_mix("bulk_exact")["classes"]
    assert {m["name"] for m in cell.end_to_end} == {"qps.graph", "recall_at_10", "setup_s"}


def test_limits_hold_short_share_and_no_exact_gap():
    cell = bench.Cell(M, IVF)
    promised = check.promises(cell.mix["params"], cell.config["index"])
    assert promised == {"exact": False, "hard_all": True}
    assert set(cell.limits) == {"predicates", "malformed", "score_gap", "short_share"}
    assert cell.limits["predicates"] == cell.limits["malformed"] == 0
    assert cell.limits["score_gap"] == 3e-5
    assert 0 <= cell.limits["short_share"] <= 0.01


@pytest.mark.parametrize("name", READERS)
def test_per_layer_names_resolve_to_their_readers(name):
    cell = bench.Cell(M, IVF)
    metric = next(m for m in cell.per_layer if m["name"] == name)
    assert metric["workloads"] == [IVF] and metric["moves"] == "qps.graph"
    assert metric["layer"] == "partitioned backend"
    known = {p.stem for p in (bench.HERE / "layer_metrics").glob("*.py")}
    assert bench.quantity(name, known) == name
    assert callable(bench.reader(name))


def test_the_cell_reports_the_graph_quantities_and_the_device_share():
    names = {m["name"] for m in bench.Cell(M, IVF).per_layer}
    assert names == set(READERS) | {"device.idle_pct.graph", "build.build_s"}


def test_configuration_is_the_flat_sift_data_with_a_partitioned_index():
    body, flat = config_body(CONFIG), config_body(FLAT_SIBLING)
    data_keys = set(flat) - {"name", "source", "index", "assumed"}
    assert {k: body[k] for k in data_keys} == {k: flat[k] for k in data_keys}
    assert body["index"] == {"help": {}, "quant": None, "partition": {
        "n_partitions": 128, "kmeans_iters": 50, "residency_rows": None}}
    assert body["assumed"][: len(flat["assumed"])] == flat["assumed"]
    assert len(body["assumed"]) == len(flat["assumed"]) + 3


class Built(Exception):
    """Raised by a recording build, so that nothing is built."""


def _record(monkeypatch):
    calls = []

    def recorder(name):
        def record(*args, **kw):
            calls.append((name, args, kw))
            raise Built
        return record

    monkeypatch.setattr(api.Engine, "build", recorder("build"))
    monkeypatch.setattr(api.Engine, "build_partitioned", recorder("build_partitioned"))
    return calls


def _host_arrays():
    rng = np.random.default_rng(0)
    return rng.normal(size=(16, 4)).astype(np.float32), rng.integers(0, 3, (16, 3))


@pytest.mark.parametrize("config", FLAT)
def test_flat_configurations_reach_engine_build_with_the_parents_arguments(config, monkeypatch):
    calls = _record(monkeypatch)
    cfg = config_body(config)
    features, attrs = _host_arrays()
    with pytest.raises(Built):
        bench.build_engine(api, cfg, features, attrs, CPU)
    (name, args, kw), = calls
    assert name == "build" and args == (features, attrs)
    assert kw == {"help_cfg": HelpConfig(**cfg["index"]["help"]), "quant_cfg": None, "device": CPU}


def test_the_partitioned_configuration_reaches_build_partitioned(monkeypatch):
    calls = _record(monkeypatch)
    features, attrs = _host_arrays()
    with pytest.raises(Built):
        bench.build_engine(api, config_body(CONFIG), features, attrs, CPU)
    (name, args, kw), = calls
    assert name == "build_partitioned"
    assert args[0] is features and args[1] is attrs and args[2] == 128
    assert kw == {"help_cfg": HelpConfig(), "quant_cfg": None, "device": CPU,
                  "residency_rows": None, "kmeans_iters": 50}
