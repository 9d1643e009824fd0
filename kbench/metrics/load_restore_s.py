"""load_restore_s: host seconds of load_keynet's restore phase in this
run's set-up (the ops, the keyed model and the sensor built from the
snapshot's arrays), as the program records them in
keynet_tpu_torch.profiling.LOAD_SECONDS["restore"].  Nothing where the
program keeps no such record."""

import sys


def read(record):
    prof = sys.modules.get("keynet_tpu_torch.profiling")
    return getattr(prof, "LOAD_SECONDS", {}).get("restore")
