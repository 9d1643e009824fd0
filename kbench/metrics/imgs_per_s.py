"""imgs_per_s: images whose outputs reached the host in the measured
window, over the window (from the first send to the last output on the
host), host clock."""


def read(record):
    return record["images"] / record["window_s"]
