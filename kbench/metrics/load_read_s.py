"""load_read_s: host seconds of load_keynet's read phase in this run's
set-up (opening the snapshot, reading and inflating its members), as the
program records them in keynet_tpu_torch.profiling.LOAD_SECONDS["read"].
Nothing where the program keeps no such record."""

import sys


def read(record):
    prof = sys.modules.get("keynet_tpu_torch.profiling")
    return getattr(prof, "LOAD_SECONDS", {}).get("read")
