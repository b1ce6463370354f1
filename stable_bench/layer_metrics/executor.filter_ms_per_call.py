"""Host time of the traversal's post-filter a call: the ``filter`` spans
(``Engine._predicate_filter``: ids to the host, the predicates in numpy,
the re-sort) summed over the traced calls' ``search`` roots
(``program_spans``), over the roots. Nothing where the program kept no
root."""
from stable_bench import program_spans


def read(ctx):
    roots = program_spans.roots()
    if not roots:
        return None
    return 1e3 * sum(s.duration for r in roots for s in program_spans.named(r, "filter")) / len(roots)
