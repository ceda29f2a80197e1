"""reduce_roofline (layer reduction, ``ops/tree_reduce.py``: K2, K3): the
least time of the nodes the window's streams reduce on the device
(``roofline.device_nodes``; the merge of slice roots left out) over the
summed time of these kernels in the trace, in percent."""

from collections import Counter

from portbench import roofline

KERNELS = ("fold_level_kernel", "tail_reduce_kernel")


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    nodes = sum(times * roofline.device_nodes(run.pool.leaves[i], int(cfg["slice_log2"]), int(cfg["host_tail_leaves"]))
                for i, times in Counter(r.index for r in run.records).items())
    ops, nbytes = roofline.reduce_work(nodes)
    return roofline.share_percent(ops, nbytes, run.trace.kernel_s(KERNELS))
