"""The window's decode wall time, from each batch's first token on the host
to its last answer, over all its decode steps (ms a step, host clock)."""


def read(ctx):
    steps = sum(b.steps for b in ctx.batches)
    if not steps:
        return None
    return 1e3 * sum(b.t_done - b.t_first for b in ctx.batches) / steps
