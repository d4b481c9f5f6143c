"""The program's own host time a decode step (ms): the mean ``decode_step``
span of the spanned batch (``ecobench/spanned.py``).  Nothing without
spans, or when they are not one a step."""
from ecobench.spanned import durations


def read(ctx):
    sp = getattr(ctx, "spans", None)
    if sp is None:
        return None
    d = durations(sp, "decode_step")
    if not d or len(d) != sp.batch.steps:
        return None
    return sum(d) / len(d) / 1e6
