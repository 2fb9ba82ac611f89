"""The aggregation calls' least time over the device time the
aggregation layer took, over the traced train window."""


def read(ctx):
    if ctx.device_ops == 0:  # no device ran: nothing to read
        return None
    s = ctx.layer_s.get("aggregation", 0.0)
    if ctx.kind != "train" or s <= 0:
        return None
    return 100.0 * ctx.least_s["aggregation"] / s
