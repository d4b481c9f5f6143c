"""95th percentile of time to first token over every request of the
window: a request's time runs from its batch's send to the batch's first
token on the host, so each batch gives B equal values (host clock)."""
import statistics


def read(ctx):
    ttft = [1e3 * (b.t_first - b.t_send) for b in ctx.batches
            for _ in range(b.B)]
    if len(ttft) < 2:
        return None
    return statistics.quantiles(ttft, n=20, method="inclusive")[-1]
