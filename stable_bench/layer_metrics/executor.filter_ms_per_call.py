"""Host time of the traversal's post-filter a call: the ``filter`` spans
(``Engine._predicate_filter``: the candidates' attribute rows gathered from
the engine's device table, or from a partitioned index's host table and
uploaded, their predicates tested on the device, the re-sort) summed over
the traced calls' ``search`` roots (``program_spans``), over the roots.
Nothing where the program kept no root."""
from stable_bench import program_spans


def read(ctx):
    roots = program_spans.roots()
    if not roots:
        return None
    return 1e3 * sum(s.duration for r in roots for s in program_spans.named(r, "filter")) / len(roots)
