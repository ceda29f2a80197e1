"""setup_s: process start to the end of the warm-up: imports, the kernels'
load (and build, in a checkout's first run), the pool of streams, the
engine and its warm-up streams."""


def read(run):
    return run.setup_s
