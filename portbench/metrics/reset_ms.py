"""reset_ms (layer engine, ``models/cuda.py::Reset``): the bench's spans
around ``Reset()`` between the window's streams, summed, over their
count."""


def read(run):
    spans = [r.spans["Reset"] for r in run.records if "Reset" in r.spans]
    return sum(spans) / len(spans) * 1e3 if spans else None
