"""blocksparse_ms.batch: device ms a whole request of the traced window
charged to BlockSparseOp and PermutedBlockSparseOp links (the program's
keynet.layer / keynet.link spans, kbench/spans.py).  Nothing when the trace
is missing or stale, when less than 99% of the window's kernel time is
charged to program spans, or when the window holds no whole request."""

from kbench import spans


def read(record):
    return spans.per_request_ms(record, "blocksparse")
