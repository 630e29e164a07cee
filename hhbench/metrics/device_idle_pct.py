"""1 − (union of the device's operations ÷ wall) over the traced window
(the first traced request's start to the last one's end), in %."""


def read(run):
    if run.traced is None or not run.traced.spans:
        return None
    busy, wall = run.traced.busy()
    return 100.0 * (1.0 - busy / wall)
