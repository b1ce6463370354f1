"""``fused_auto``'s share of its roofline in the partitioned searcher: the
least time of the ``fused_auto`` work of the traced calls over the device
time of the kernels named ``fused_auto`` in the trace. The work is each
``group`` span's scan of its padded sub-batch against its padded partition
(``roofline.fused_auto_work(bucket, rows, dim, attr_dim)``) and each call's
centroid scores (its ``batch`` against the ``partitions_scored`` centroids
of its ``probe`` span, one attribute column), from the program's spans
(``program_spans``). Nothing where the program kept no probe, or the trace
holds no such kernel."""
from stable_bench import program_spans, roofline


def read(ctx):
    least, probes = 0.0, 0
    for root in program_spans.roots():
        probe = program_spans.named(root, "probe")
        if not probe:
            continue
        cfg = ctx["config"]
        dim, attr_dim = cfg["dim"], cfg["attr_dim"]
        for p in probe:
            probes += 1
            least += roofline.least_time_s(*roofline.fused_auto_work(
                root.attrs["batch"], p.attrs["partitions_scored"], dim, 1))
        for g in program_spans.named(root, "group"):
            least += roofline.least_time_s(*roofline.fused_auto_work(
                g.attrs["bucket"], g.attrs["rows"], dim, attr_dim))
    if not probes:
        return None
    busy = sum(b - a for name, ivs in ctx["trace"]["ops"].items() if "fused_auto" in name
               for a, b in ivs)
    return 100.0 * least / busy if busy > 0 else None
