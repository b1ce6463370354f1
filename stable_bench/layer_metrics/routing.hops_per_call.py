"""Mean expansion iterations of a call (``SearchResult.n_hops``) over the
window; nothing where no call traversed the graph."""


def read(ctx):
    hops = [c["hops"] for c in ctx["calls"]]
    return sum(hops) / len(hops) if any(hops) else None
