"""h2d_gbps (layer device): the bytes of the trace's host-to-device copies
over their summed time."""


def read(run):
    h2d = None if run.trace is None else run.trace.h2d()
    if h2d is None or h2d[1] <= 0:
        return None
    return h2d[0] / h2d[1] / 1e9
