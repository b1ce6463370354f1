"""Mean host time of one probed partition's group: the ``group`` spans of
the traced calls (``program_spans``), each the store's lookup, the upload
of the sub-batch's indices, the scan, the mask, the select and the scatter
issued for one partition. Nothing where the program kept no such span."""
from stable_bench import program_spans


def read(ctx):
    return program_spans.mean_ms("group")
