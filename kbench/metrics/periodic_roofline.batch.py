"""periodic_roofline.batch: the periodic Block-ELL kernel's share of its
roofline in the traced window: the yardstick's bound of the periodic
launches of a request (the larger of FLOPs over the product's peak and
least bytes over 3.35 TB/s) times the requests, over the device time of the
kernels named periodic_kernel / periodic_wgmma, in %.  Nothing when no
periodic kernel ran or the trace holds another number of them."""

from kbench import yardstick

PATTERN = r"\bperiodic_(kernel|wgmma)\b"


def read(record):
    return yardstick.roofline(record, "periodic", PATTERN)
