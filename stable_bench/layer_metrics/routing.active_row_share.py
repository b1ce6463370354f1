"""Share of a hop's rows that the hop works for: over every stop test
followed by a hop in the traced calls (``program_spans``), the sum of its
``active`` rows over the sum of its call's ``batch``. Nothing where the
program kept no such stop test."""
from stable_bench import program_spans


def read(ctx):
    active = rows = 0
    for root in program_spans.roots():
        for stage in program_spans.named(root, "coarse") + program_spans.named(root, "refine"):
            kids = stage.children
            for test, nxt in zip(kids, kids[1:]):
                if test.name == "stop_test" and nxt.name == "hop":
                    active += test.attrs["active"]
                    rows += root.attrs["batch"]
    return 100.0 * active / rows if rows else None
