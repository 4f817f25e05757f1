"""Milliseconds per request in which the card ran nothing while the
program was inside the request (its `serve.request` span): each span's
length less its union with the device's activities. Reads the stretch's
span records on the device clock (`r.spans`, `spans.stretch_spans`),
which `benchmark/run.py` does not gather yet: until it does this reads
None, and `python3 -m benchmark.spans` gives the number (PERF.md)."""

from benchmark import spans


def read(r):
    recs = getattr(r, "spans", None)
    if recs is None or getattr(r, "spans_dropped", 0) or r.acts is None:
        return None
    return spans.span_idle_ms(recs, r.acts, "serve.request")
