"""ingest_gbps (layer ingest, ``ingest.py``): the window's stream bytes over
the bench's spans around each ``next()`` of ``iter_line_spans``."""


def read(run):
    spent = sum(r.spans["ingest_next"] for r in run.records)
    return sum(r.nbytes for r in run.records) / spent / 1e9 if spent > 0 else None
