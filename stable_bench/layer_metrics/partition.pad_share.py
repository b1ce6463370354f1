"""Share of the (query, row) pairs the partitioned scans score that padding
wastes: over the ``group`` spans of the traced calls (``program_spans``),
1 − Σ queries · rows_real / Σ bucket · rows, where a group's sub-batch of
``queries`` is padded to ``bucket`` and its partition of ``rows_real`` rows
to ``rows``. Nothing where the program kept no such span."""
from stable_bench import program_spans


def read(ctx):
    real = scored = 0
    for root in program_spans.roots():
        for g in program_spans.named(root, "group"):
            real += g.attrs["queries"] * g.attrs["rows_real"]
            scored += g.attrs["bucket"] * g.attrs["rows"]
    return 100.0 * (1.0 - real / scored) if scored else None
