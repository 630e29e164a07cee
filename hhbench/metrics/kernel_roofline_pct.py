"""The least time the traced requests' work needs (``work/``, at the
peaks of ``peaks.json``) over the device time of the program's own
kernels in those requests, in %."""

from ..trace import program_kernel


def read(run):
    least = kernel = 0.0
    for rec, span in run.traced_records():
        need = run.least_seconds(rec)
        if need is None:
            return None
        least += need
        kernel += sum(e[1] - e[0] for e in run.traced.ops_in(span) if program_kernel(e))
    if kernel <= 0.0:
        return None
    return 100.0 * least / kernel
