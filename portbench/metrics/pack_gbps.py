"""pack_gbps (layer host packer, ``packing.py``, ``native/``,
``models/host.py``): payload bytes over the pack thread's StopWatch, the
``pack`` stage of the engine's ``Stats()``, summed over the window's
streams."""


def read(run):
    stages = [r.stages["pack"] for r in run.records if "pack" in r.stages]
    ms = sum(s["ms"] for s in stages)
    return sum(s.get("bytes", 0) for s in stages) / (ms * 1e6) if ms > 0 else None
