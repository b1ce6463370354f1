"""Mean host time of the partitioned searcher's probe: the ``probe`` spans of
the traced calls (``program_spans``), the coarse centroid scores, their copy
to the host, the summary pruning and the probe order. Nothing where the
program kept no such span."""
from stable_bench import program_spans


def read(ctx):
    return program_spans.mean_ms("probe")
