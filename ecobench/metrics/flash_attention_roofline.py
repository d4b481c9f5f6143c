"""The prefill attention kernel's share of its roofline (%), over the
traced batch (``harness.roofline``): the summed least time of its launches
over their summed device time, both as the cell's family counts them under
this key (``kernel_bounds``).  Nothing when the family lists no such
kernel, or the trace holds none of it or not the launches the family
counts."""
from ecobench.harness import roofline


def read(ctx):
    return roofline(ctx, "flash_attention")
