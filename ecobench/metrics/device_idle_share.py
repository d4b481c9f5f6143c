"""The share of the traced batch in which no operation ran on the device
(%): 1 - the union of its device activities over the batch's length."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.busy_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
