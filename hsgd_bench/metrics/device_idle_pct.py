"""Share of the traced window in which no kernel, copy or memset ran on the
device (the union of their intervals against the host clock's window), in
the rounds traced with the device's activity alone."""
LAYER = "device: H100"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(ctx):
    t = ctx["traced"]
    if not t["device"]:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])
