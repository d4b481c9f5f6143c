"""Requests answered per second over the whole window: every request of
every batch it sent, over its length on the host clock (it closes at the
end of a whole cycle, so no batch is cut)."""


def read(ctx):
    return sum(b.B for b in ctx.batches) / ctx.window_s
