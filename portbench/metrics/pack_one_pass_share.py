"""pack_one_pass_share (layer host packer, ``packing.pack_flush`` called by
``models/cuda.py::_pack_worker``): the share of the window's flushes that
the engine's one native pass packed, in %, the ``pack_one_pass`` stage's
count over the ``pack`` stage's, summed over the window's streams.  None
from a program that has no ``pack_one_pass`` stage."""


def read(run):
    stages = [r.stages for r in run.records if "pack" in r.stages]
    if not any("pack_one_pass" in s for s in stages):
        return None
    flushes = sum(s["pack"]["count"] for s in stages)
    return 100.0 * sum(s.get("pack_one_pass", {"count": 0})["count"] for s in stages) / flushes
