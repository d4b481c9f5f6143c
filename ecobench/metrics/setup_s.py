"""Process start to the window's start: imports, the kernel library (built
on a checkout's first run, loaded after), weights made on the card, and a
warm-up prefill of every prompt length with two decode steps."""


def read(ctx):
    return ctx.setup_s
