"""``fused_auto``'s share of its roofline over the traced calls: the least
time the traced calls' brute scans need (each call scores its batch
against every row once, ``roofline.fused_auto_work``) over the device time
of the kernels named ``fused_auto`` in the trace. Nothing where the trace
holds no such kernel."""
from stable_bench import roofline


def read(ctx):
    trace = ctx["trace"]
    spans = [iv for name, ivs in trace["ops"].items() if "fused_auto" in name for iv in ivs]
    busy = sum(b - a for a, b in spans)
    if busy <= 0:
        return None
    cfg = ctx["config"]
    least = sum(
        roofline.least_time_s(*roofline.fused_auto_work(
            c["batch"], cfg["n_rows"], cfg["dim"], cfg["attr_dim"]))
        for c in ctx["traced_calls"]
    )
    return 100.0 * least / busy
