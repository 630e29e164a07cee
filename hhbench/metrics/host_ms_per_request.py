"""The mean, over the traced requests, of each request's span less the
union of the device's operations inside it: the host's share of a
request, in ms."""

from ..stats import clip, union_seconds


def read(run):
    traced = run.traced_records()
    if not traced:
        return None
    host = [(b - a) - union_seconds(clip(run.traced.device, a, b)) for _, (a, b) in traced]
    return 1e3 * sum(host) / len(host)
