"""residual_roofline.batch: the residual adds' share of their roofline in
the traced window: a request's least bytes (per shortcut the input
coordinates its keyed matrix reads, the branch output read and the sum
written, its values and indices, each once), at 3.35 TB/s, computed by
kbench/residual.py from what the program keeps in
keynet_tpu_torch.profiling.RESIDUAL, times the whole requests, over the
kernel time charged to keynet.residual spans, in %.
The shortcuts of a request are the counter's last applies, as many as a
whole request of the trace holds.  Nothing where the program keeps no such
counter or span, or where those last applies are not as many distinct
shortcuts at the run's batch."""

import sys

from kbench import residual


def read(record):
    prof = sys.modules.get("keynet_tpu_torch.profiling")
    return residual.roofline(record, getattr(prof, "RESIDUAL", None))
