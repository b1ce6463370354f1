"""Full-precision distance evaluations of a query (``SearchResult.n_dist_evals``
summed over the window's calls, over the queries answered); nothing where
no call traversed the graph."""


def read(ctx):
    calls = [c for c in ctx["calls"] if c["hops"]]
    if not calls:
        return None
    return sum(c["evals"] for c in calls) / sum(c["batch"] for c in calls)
