"""grouped_roofline.batch: the grouped-row applies' share of their roofline
in the traced window: a request's bound (per apply the larger of its FLOPs,
2·B·TM·TN a non-zero slot of each row-block, at the configuration's step
peak, 67 TFLOP/s for IEEE f32, and its least bytes, each distinct non-zero
tile, each x block a non-zero slot reads and the output once, at 3.35 TB/s,
counted as yardstick.slot_walk_work counts a launch), computed by
kbench/grouped.py from what the program keeps in
keynet_tpu_torch.profiling.GROUPED_ROWS, times the whole requests, over the
kernel time charged to keynet.grouped spans, in %.
The cores of a request are the counter's last applies, as many as a whole
request of the trace holds (the keyed sensor's cores applied before them).
Nothing where the program keeps no such counter or span, or where those last
applies are not as many distinct cores at the run's batch."""

import sys

from kbench import grouped


def read(record):
    prof = sys.modules.get("keynet_tpu_torch.profiling")
    return grouped.roofline(record, getattr(prof, "GROUPED_ROWS", None))
