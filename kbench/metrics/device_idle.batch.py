"""device_idle.batch: the share of the traced window in which no kernel,
copy or set ran on the card, in %."""

from kbench import yardstick


def read(record):
    return yardstick.idle_percent(record)
