"""The ball queries', FPS's and 1-NN's least time over the device time
the geometry layer took, over the traced train window."""


def read(ctx):
    if ctx.device_ops == 0:  # no device ran: nothing to read
        return None
    s = ctx.layer_s.get("geometry", 0.0)
    if ctx.kind != "train" or s <= 0:
        return None
    return 100.0 * ctx.least_s["geometry"] / s
