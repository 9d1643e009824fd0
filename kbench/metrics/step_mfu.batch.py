"""step_mfu.batch: the source network's FLOPs of the images served in the
traced window, over the traced window, as a share of the card's peak for the
configuration's arithmetic (67 TFLOP/s for IEEE f32), in %."""


def read(record):
    t = record["trace"]
    if not t or not t["busy_us"]:       # no device in the trace
        return None
    images = record["batch"] * len(record["trace_requests"])
    return 100.0 * images * record["flops_per_image"] / (t["span_us"] / 1e6) / record["step_peak"]
