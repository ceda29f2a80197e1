"""flush_dispatch_ms (layer engine, ``models/cuda.py``): the host time to
enqueue one packed flush, the ``map_dispatch`` stage of the engine's
``Stats()`` over its count, summed over the window's streams."""


def read(run):
    stages = [r.stages["map_dispatch"] for r in run.records if "map_dispatch" in r.stages]
    count = sum(s["count"] for s in stages)
    return sum(s["ms"] for s in stages) / count if count else None
