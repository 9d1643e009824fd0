"""launches_per_req.batch: kernels launched inside the program's
keynet.forward spans of the traced window, over its whole requests
(kbench/spans.py).  Nothing when the trace is missing or stale, when less
than 99% of the window's kernel time is charged to program spans, or when
the window holds no whole request."""

from kbench import spans


def read(record):
    r = spans.for_record(record)
    return None if r is None else r["forward_kernels"] / r["requests"]
