"""Device time per traced request in operations the program did not
write (PyTorch's kernels, copies and fills: casts, float64 reductions,
staging), in ms."""

from ..trace import program_kernel


def read(run):
    traced = run.traced_records()
    if not traced:
        return None
    aux = sum(e[1] - e[0] for _, span in traced for e in run.traced.ops_in(span)
              if not program_kernel(e))
    return 1e3 * aux / len(traced)
