"""The 95th percentile (nearest rank), over all requests completed in the
window, of submission to result on the host, in ms."""

from ..stats import percentile


def read(run):
    if not run.done:
        return None
    return 1e3 * percentile([r.latency for r in run.done], 95)
