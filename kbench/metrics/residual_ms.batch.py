"""residual_ms.batch: device ms a whole request of the traced window charged
to the program's keynet.residual spans, one around each residual ReLU's
shortcut apply and add (KeyedModel._add_residual; kbench/residual.py).
Nothing when the trace is missing or stale, when less than 99% of the
window's kernel time is charged to program spans, or when no
keynet.residual span lies in a whole request (a program without the span)."""

from kbench import residual


def read(record):
    return residual.per_request_ms(record)
