"""The host time a layer a decode step (us): the mean ``block`` span
directly under a ``decode_step`` span of the spanned batch
(``ecobench/spanned.py``).  Nothing without spans, or when they are not
one a layer a step."""
from ecobench.spanned import durations


def read(ctx):
    sp = getattr(ctx, "spans", None)
    if sp is None:
        return None
    d = durations(sp, "block", parent="decode_step")
    if not d or len(d) != ctx.dims.layers * sp.batch.steps:
        return None
    return sum(d) / len(d) / 1e3
