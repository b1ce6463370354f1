"""The trace reduction and the device readers on a made-up trace."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from stable_bench import bench, devtrace, roofline


def ev(name, start, end, dev=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=dev, is_user_annotation=annotation)


def trace():
    gpu = DeviceType.CUDA
    return devtrace.reduce([
        ev("bench.window", 0, 1000, annotation=True),
        ev("search.match", 10, 990, annotation=True),
        ev("aten::sort", 100, 300),
        ev("cudaStreamSynchronize", 400, 600),
        ev("fused_auto_kernel<128>", 150, 250, gpu),
        ev("radixSort", 200, 450, gpu),  # overlaps the kernel before it
        ev("Memcpy DtoH", 700, 800, gpu),
        ev("gpu_user_annotation", 0, 1000, gpu, annotation=True),
        ev("late kernel", 1200, 1300, gpu),  # outside the window
    ], "bench.window")


def test_busy_is_the_union_inside_the_window():
    t = trace()
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["busy_s"] == pytest.approx((450 - 150 + 100) * 1e-6)
    assert "late kernel" not in t["ops"] and "gpu_user_annotation" not in t["ops"]


def test_breakdown_names_gaps_by_the_innermost_host_event():
    b = dict((n, s) for n, s in trace()["breakdown"]["idle_gaps"])
    # gaps [0, 150], [450, 700], [800, 1000], each named as it begins
    assert b == pytest.approx({"outside any span": 150e-6, "cudaStreamSynchronize": 250e-6,
                               "search.match": 200e-6})
    ops = dict(trace()["breakdown"]["device_ops"])
    assert ops["radixSort"] == pytest.approx(250e-6)


def test_device_readers():
    t = trace()
    cfg = {"n_rows": 1_000_000, "dim": 128, "attr_dim": 5}
    ctx = {"trace": t, "config": cfg, "traced_calls": [{"batch": 128}]}
    idle = bench.reader("device.idle_pct")(ctx)
    assert idle == pytest.approx(60.0)
    least = roofline.least_time_s(*roofline.fused_auto_work(128, 1_000_000, 128, 5))
    assert least == pytest.approx(0.5005e-3, rel=1e-3)
    assert bench.reader("fused_auto_roofline")(ctx) == pytest.approx(100 * least / 100e-6)
    t["ops"] = {}
    assert bench.reader("fused_auto_roofline")(ctx) is None


def test_counter_readers():
    calls = [{"batch": 4, "hops": 10, "evals": 400}, {"batch": 4, "hops": 20, "evals": 600}]
    ctx = {"calls": calls, "executor": {"hits": 3, "misses": 1}, "build_s": 2.5}
    assert bench.reader("routing.hops_per_call")(ctx) == 15
    assert bench.reader("routing.evals_per_query")(ctx) == 125
    assert bench.reader("executor.plan_hit_rate")(ctx) == 0.75
    assert bench.reader("build.build_s")(ctx) == 2.5
    ctx["calls"] = [{"batch": 4, "hops": 0, "evals": 4000}]
    assert bench.reader("routing.hops_per_call")(ctx) is None
    assert bench.reader("routing.evals_per_query")(ctx) is None
