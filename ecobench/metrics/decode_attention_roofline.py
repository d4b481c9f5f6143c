"""The decode attention kernel's share of its roofline (%), over the traced
batch: the summed least time of its launches (``costs.decode_cost`` over
the live cache, S + t + 1 positions at step t, one launch a layer a step)
over the summed device time of ``decode_attention_tc_kernel`` and its
split combine in the trace.  Nothing when the trace holds no such kernel
or not one a layer a step."""
from ecobench import costs
from ecobench.harness import DECODE_KERNELS


def read(ctx):
    tr, m = ctx.trace, ctx.dims
    if tr is None:
        return None
    seconds, _ = tr.kernel_time(DECODE_KERNELS)
    _, launches = tr.kernel_time(DECODE_KERNELS[:1])
    if not seconds or launches != m.layers * sum(b.steps for b in tr.batches):
        return None
    bound = sum(m.layers * costs.bound_s(*costs.decode_cost(
        b.B, m.heads, m.kv_heads, m.head_dim, b.S + t + 1))
        for b in tr.batches for t in range(b.steps))
    return 100.0 * bound / seconds
