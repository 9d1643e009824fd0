"""slot_walk_roofline.batch: the Block-ELL slot walk's share of its
roofline in the traced window: the yardstick's bound of the slot-walk
launches of a request (xresd and xres2 entries) times the requests, over the
device time of the kernels named slot_walk_kernel / slot_walk_wgmma, in %.
Nothing when no slot walk ran or the trace holds another number of them."""

from kbench import yardstick

PATTERN = r"\bslot_walk_(kernel|wgmma)\b"


def read(record):
    return yardstick.roofline(record, "slot_walk", PATTERN)
