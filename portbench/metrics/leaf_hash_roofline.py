"""leaf_hash_roofline (layer leaf hashing, ``ops/leaf_hash.py``: K1, K4):
the least time the window's leaves need (``roofline.leaf_work``) over the
summed time of these kernels in the trace, in percent."""

from collections import Counter

from portbench import roofline

KERNELS = ("leaf_hash_exact_kernel", "leaf_hash_stream_kernel")


def read(run):
    if run.trace is None:
        return None
    ops = nbytes = 0
    for i, times in Counter(r.index for r in run.records).items():
        o, b = roofline.leaf_work(run.pool.lengths(i), int(run.cell.config["device_max_blocks"]))
        ops, nbytes = ops + times * o, nbytes + times * b
    return roofline.share_percent(ops, nbytes, run.trace.kernel_s(KERNELS))
