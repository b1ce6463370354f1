"""Share of the window's searches whose plan the executor found compiled
(``Executor.stats()``: hits over hits and misses)."""


def read(ctx):
    ex = ctx["executor"]
    total = ex["hits"] + ex["misses"]
    return ex["hits"] / total if total else None
