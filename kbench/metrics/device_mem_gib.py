"""device_mem_gib: torch.cuda.max_memory_allocated() from the end of the
pool's encryption (the camera's side: the keyed sensor, the plaintext
images) to the end of the window: the keyed model, the activations and the
request on the card; the pool stays on the host.  In GiB."""


def read(record):
    return record["memory_peak_bytes"] / 2 ** 30 if record["memory_peak_bytes"] else None
