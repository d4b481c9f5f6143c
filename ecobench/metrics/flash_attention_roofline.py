"""The prefill attention kernel's share of its roofline (%), over the
traced batch: the summed least time of its launches (``costs.flash_cost``
at each prefill's shape, one launch a layer) over the summed device time
of ``flash_attention_tc_kernel`` in the trace.  Nothing when the trace
holds no such kernel or not one a layer a prefill."""
from ecobench import costs
from ecobench.harness import FLASH_KERNELS


def read(ctx):
    tr, m = ctx.trace, ctx.dims
    if tr is None:
        return None
    seconds, launches = tr.kernel_time(FLASH_KERNELS)
    if not seconds or launches != m.layers * len(tr.batches):
        return None
    bound = sum(m.layers * costs.bound_s(*costs.flash_cost(
        b.B, b.S, m.heads, m.kv_heads, m.head_dim)) for b in tr.batches)
    return 100.0 * bound / seconds
