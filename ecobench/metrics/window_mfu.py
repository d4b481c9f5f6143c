"""Model FLOPs of every prefill and decode step of the window over the
window's length, as a share of the H100's bf16 peak (%): the whole step's
share of peak, which bounds any gain once a kernel leaves the path.  FLOPs
from the cell's family (``prefill_flops``, ``decode_flops``)."""
from ecobench import costs


def read(ctx):
    fam, c = ctx.family, ctx.config
    flops = 0
    for b in ctx.batches:
        flops += fam.prefill_flops(c, b.B, b.S)
        # decode step t runs the token at position S + t: S + t + 1 cached
        flops += sum(fam.decode_flops(c, b.B, b.S + t + 1)
                     for t in range(b.steps))
    return 100.0 * flops / (ctx.window_s * costs.PEAK_BF16_FLOPS)
