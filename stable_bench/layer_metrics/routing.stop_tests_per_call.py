"""Stop tests of the graph loop a call: ``stop_test`` spans over ``search``
roots, in the traced calls (``program_spans``). Nothing where the program
kept no root, or no root a stop test."""
from stable_bench import program_spans


def read(ctx):
    roots = program_spans.roots()
    tests = sum(len(program_spans.named(r, "stop_test")) for r in roots)
    return tests / len(roots) if tests else None
