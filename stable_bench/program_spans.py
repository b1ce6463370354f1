"""The program's own spans of the traced calls: the span trees that
``repro_torch.obs.trace`` keeps of every ``Engine.search`` made while
``torch.profiler`` records (``profiled_traces()``), which in a run are the
calls of the traced part of the window. A program without that store gives
no trees, and every reader built on them then reports nothing."""
from __future__ import annotations


def roots() -> list:
    """The ``search`` roots the program kept, oldest first."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return []
    kept = getattr(trace, "profiled_traces", None)
    return [t.root for t in kept()] if kept is not None else []


def named(span, name: str) -> list:
    """Every span called ``name`` in the tree under ``span``, itself included,
    depth first."""
    out = [span] if span.name == name else []
    for c in span.children:
        out.extend(named(c, name))
    return out


def mean_ms(name: str):
    """Mean length of the spans called ``name`` over every root, in ms;
    None where there is none."""
    spans = [s for r in roots() for s in named(r, name)]
    return 1e3 * sum(s.duration for s in spans) / len(spans) if spans else None
