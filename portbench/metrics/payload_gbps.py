"""payload_gbps: the bytes of every stream of the window, as piped (leaf
bytes and their newlines), over the window, first chunk to last root."""


def read(run):
    return sum(r.nbytes for r in run.records) / run.window_s / 1e9
