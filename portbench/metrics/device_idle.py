"""device_idle (layer device): one less the union of every kernel, memcpy
and memset interval of the window's profiler trace over the window, in
percent."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
