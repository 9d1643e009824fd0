"""h2d_ms.batch: the request's copy to the device, the median over the
traced window's whole requests of the host duration of the program's
keynet.h2d span (kbench/spans.py), in ms.  The copy of the pinned cipher
batch is synchronous, so the span runs from the start of the copy on the
host to the end of the DMA as the host sees it, on one clock (the device's
clock drifts from the host's within a trace).  Nothing when the trace is
missing or stale, when less than 99% of the window's kernel time is charged
to program spans, or when the window holds no whole request."""

import statistics

from kbench import spans


def read(record):
    r = spans.for_record(record)
    return statistics.median(r["h2d_us"]) / 1e3 if r and r["h2d_us"] else None
