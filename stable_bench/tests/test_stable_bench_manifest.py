"""BENCHMARK.json against the benchmark's contract, and everything it names
found by name."""
import json
import re

import pytest

from stable_bench import bench, check
from stable_bench.tests.helpers import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves", "bound", "workloads"}

M = manifest()


def all_metrics():
    return M["end_to_end"] + M["per_layer"]


def test_keys_and_size():
    assert set(M) == KEYS
    assert len(json.dumps(M)) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16 and len(M["command"]) <= 32
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
    assert not any(w.startswith("/") or ".." in w for w in M["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", [m["name"] for m in all_metrics()])
def test_metric_fields(metric):
    m = next(x for x in all_metrics() if x["name"] == metric)
    assert set(m) <= METRIC_KEYS
    assert UNIT.match(m["unit"]) and len(m["unit"]) <= 16
    assert m["better"] in ("lower", "higher")
    if m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert m["bound"] >= 0.01
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and "bound" not in m


def test_setup_metric_and_names_of_cells():
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}
    # each end-to-end metric is a quantity the harness measures
    assert all(bench.quantity(m["name"], bench.END_TO_END) in bench.END_TO_END
               for m in M["end_to_end"])
    work = {w["name"] for w in M["workloads"]}
    for m in all_metrics():
        assert set(m.get("workloads", [])) <= work


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_what_its_metrics_move(cell):
    c = bench.Cell(M, cell)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "each cell reports a per-layer metric"
    for m in M["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in reported, (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_found_by_name(cell):
    c = bench.Cell(M, cell)
    w = c.workload
    assert w["chips"] in (1, 4) and LINE.match(w["why"])
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert c.config["name"] == w["config"]
    assert set(c.limits) >= {"predicates", "malformed", "score_gap"}
    assert c.limits["predicates"] == 0 and c.limits["malformed"] == 0
    promised = check.promises(c.mix["params"], c.config["index"])
    assert ("exact_gap" in c.limits) == promised["exact"]
    assert ("short_share" in c.limits) == (promised["hard_all"] and not promised["exact"])
    for m in c.per_layer:
        assert callable(bench.reader(m["name"]))
    assert c.driver.groups(c.mix, c.config["n_queries"])


@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_config_files(config):
    c = next(x for x in M["configs"] if x["name"] == config)
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith(M["paths"][0] + "/")
    body = bench.load_json(bench.ROOT / c["file"])
    assert body["reduced"] == c["reduced"] == []
    assert body["source"] == c["source"] and LINE.match(c["source"])
    assert body["latent_dim"] > 0 and "assumed" in body
    assert body["cardinality"] == body["labels_per_dim"] ** body["attr_dim"]
    assert any(w["config"] == config for w in M["workloads"])


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_check_time_fits_with_all_cells():
    run = M["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (run + 60) + 24 * 2 * 90 + 1200 <= 43200


PARTITION = {"n_partitions": 8, "residency_rows": None, "kmeans_iters": 10}
PARTITIONED = {"backend": "partitioned", "nprobe": 3, "sub_backend": "brute"}


def _partitioned(body, **extra):
    body["index"]["partition"] = dict(PARTITION, **extra)


def _without(key):
    def edit(params):
        params.update(PARTITIONED)
        del params[key]
    return edit


#: (edit of the configuration, edit of the mix's params, what the error names)
MALFORMED = {
    "config": (lambda b: b.update(pool_size=100), None, "pool_size"),
    "index": (lambda b: b["index"].update(pool_size=100), None, "pool_size"),
    "partition": (lambda b: _partitioned(b, pool_size=100), lambda p: p.update(PARTITIONED),
                  "pool_size"),
    "partition_without_n_partitions": (lambda b: b["index"].update(partition={"kmeans_iters": 10}),
                                       lambda p: p.update(PARTITIONED), "n_partitions"),
    "partitioned_mix_without_nprobe": (_partitioned, _without("nprobe"), "nprobe"),
    "partitioned_mix_without_sub_backend": (_partitioned, _without("sub_backend"), "sub_backend"),
    "partitioned_mix_with_auto_sub_backend": (_partitioned,
                                              lambda p: p.update(PARTITIONED, sub_backend="auto"),
                                              "sub_backend"),
    "partitioned_mix_with_zero_nprobe": (_partitioned, lambda p: p.update(PARTITIONED, nprobe=0),
                                         "nprobe"),
    "partitioned_index_flat_mix": (_partitioned, None, "does not take"),
    "flat_index_partitioned_mix": (None, lambda p: p.update(PARTITIONED), "does not take"),
}


@pytest.mark.parametrize("where", list(MALFORMED))
def test_a_key_the_harness_does_not_read_stops_the_run(where, monkeypatch):
    """A configuration may not state what no run honours, and a mix may not
    search an index with a backend that cannot take it: either stops the
    run before set-up."""
    edit_config, edit_params, names = MALFORMED[where]
    load, load_mix = bench.load_json, bench.loadgen.load_mix

    def config_edited(path):
        body = load(path)
        if "configs" in str(path) and edit_config:
            edit_config(body)
        return body

    def mix_edited(name):
        mix = load_mix(name)
        if edit_params:
            edit_params(mix["params"])
        return mix

    monkeypatch.setattr(bench, "load_json", config_edited)
    monkeypatch.setattr(bench.loadgen, "load_mix", mix_edited)
    with pytest.raises(ValueError, match=names):
        bench.Cell(M, M["workloads"][0]["name"])
