"""Mean time of one stop test of the graph loop: the ``stop_test`` spans of
the traced calls (``program_spans``), each a device-to-host read, so the
host blocked until the card drained the hop before it. Nothing where the
program kept no such span."""
from stable_bench import program_spans


def read(ctx):
    return program_spans.mean_ms("stop_test")
