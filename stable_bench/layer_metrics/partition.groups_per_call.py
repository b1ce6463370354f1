"""Probed partitions a call: ``group`` spans over ``search`` roots, in the
traced calls (``program_spans``). Nothing where the program kept no root,
or no root a group."""
from stable_bench import program_spans


def read(ctx):
    roots = program_spans.roots()
    groups = sum(len(program_spans.named(r, "group")) for r in roots)
    return groups / len(roots) if groups else None
