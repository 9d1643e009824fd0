"""grouped_ms.batch: device ms a whole request of the traced window charged
to the program's keynet.grouped spans, one a grouped-row apply of a
Block-ELL core (BlockSparseOp._apply_grouped; kbench/grouped.py).  Nothing
when the trace is missing or stale, when less than 99% of the window's
kernel time is charged to program spans, or when no keynet.grouped span
lies in a whole request (a program without the span)."""

from kbench import grouped


def read(record):
    return grouped.per_request_ms(record)
