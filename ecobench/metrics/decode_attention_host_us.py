"""The host time of the ``decode_attention`` wrapper (us): the mean of its
spans in the spanned batch (``ecobench/spanned.py``), from entry to return:
checks, route, split plan, scratch and the launch.  Nothing without spans,
or when they are not one a layer a decode step."""
from ecobench.spanned import durations


def read(ctx):
    sp = getattr(ctx, "spans", None)
    if sp is None:
        return None
    d = durations(sp, "decode_attention")
    if not d or len(d) != ctx.dims.layers * sp.batch.steps:
        return None
    return sum(d) / len(d) / 1e3
