"""Mean host time of one graph hop: the ``hop`` spans of the traced calls
(``program_spans``), each one expansion issued to the device with no wait
in it. Nothing where the program kept no such span."""
from stable_bench import program_spans


def read(ctx):
    return program_spans.mean_ms("hop")
