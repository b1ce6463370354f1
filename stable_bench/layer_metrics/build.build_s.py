"""Seconds of ``Engine.build`` in set-up, on the host clock, ending in a
device synchronisation."""


def read(ctx):
    return ctx["build_s"]
