"""From the first statement of hhbench/run.py to the first timed request:
imports, the CUDA context, the kernel library (built in a checkout's
first run), the cell's inputs and the warm-up of its shapes."""


def read(run):
    return run.setup_s
