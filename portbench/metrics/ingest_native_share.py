"""ingest_native_share (layer ingest, ``ingest.py``): the share of the
process's stream reads that ``iter_line_spans`` split with the native line
scan (``vkmr_split_lines``), in %, from the program's count of reads by path
(``ingest.split_reads``, warm-up included).  None from a program that has no
such count, or that split no read."""

import sys


def read(run):
    counts = getattr(sys.modules.get("vk_merkle_roots_tpu_torch.ingest"), "split_reads", None)
    if not counts:
        return None
    return 100.0 * counts["native"] / sum(counts.values())
