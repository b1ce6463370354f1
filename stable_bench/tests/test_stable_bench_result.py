"""The schema of the result line, traced and not, from a whole run of a
small cell on the CPU; the run script's refusals."""
import json
import subprocess
import sys
import time

import pytest

from repro_torch import api
from stable_bench import bench
from stable_bench.tests.helpers import CPU, small_cell


def number(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool)


@pytest.fixture(scope="module", params=[0, 1])
def result(request):
    cell = small_cell("sift1m-theta243.bulk_exact")
    out = bench.run_cell(cell, 2**31 + 7, 0.5, bool(request.param), CPU, api, time.perf_counter())
    assert out.pop("malformed_by") == {}  # run.py prints it on standard error
    return cell, request.param, json.loads(json.dumps(out))


def test_keys(result):
    cell, trace, out = result
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] or (
        trace and keys[:6] == ["correct", "attempted", "failed", "metrics", "breakdown", "device"])
    assert keys[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0


def test_metrics(result):
    cell, trace, out = result
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and number(m["value"]) and m["unit"] == units[name]
    if trace:
        # the CPU has no device trace: its readers find nothing and are left out
        assert "device.idle_pct.exact" not in out["metrics"]
        assert "fused_auto_roofline" not in out["metrics"]
        assert {"executor.plan_hit_rate.exact", "build.build_s"} <= set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert number(out["device"]["busy_s"]) and number(out["device"]["window_s"])
    else:
        assert set(out["metrics"]) == set(units)
        assert all(m["value"] > 0 for m in out["metrics"].values())


def test_device_and_checks(result):
    cell, trace, out = result
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert out["device"]["count"] == cell.workload["chips"]
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and number(c["value"]) and number(c["limit"])
        assert name in cell.limits


def test_run_script_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(bench.HERE / "run.py"), "--workload",
                        "sift1m-theta243.bulk_exact", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=120)
    assert "CUDA card" in p.stderr and p.returncode != 0 and p.stdout.strip() == ""


def test_foreign_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert all(m.split(".")[0] in bench.FORBIDDEN for m in bench.foreign_modules())
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro.fake" in bench.foreign_modules()
