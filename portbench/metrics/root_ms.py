"""root_ms (layer engine, ``models/cuda.py::Root``): the bench's spans
around ``Root()``, summed over the window's streams, over their count."""


def read(run):
    spans = [r.spans["Root"] for r in run.records if r.root is not None]
    return sum(spans) / len(spans) * 1e3 if spans else None
