"""Model FLOPs of the window's prefills over their summed wall time, from
the send to the first token on the host, as a share of the H100's bf16
peak (%).  FLOPs from the cell's family (``prefill_flops``; the dense
family's is ``costs.prefill_flops``: every product, causal attention over
the visible pairs, the head on the last position)."""
from ecobench import costs


def read(ctx):
    fam, c = ctx.family, ctx.config
    flops = sum(fam.prefill_flops(c, b.B, b.S) for b in ctx.batches)
    wall = sum(b.t_first - b.t_send for b in ctx.batches)
    return 100.0 * flops / (wall * costs.PEAK_BF16_FLOPS)
