"""Device milliseconds of the dense layer (matmuls, BatchNorm) per unit
of the traced train window."""


def read(ctx):
    if ctx.device_ops == 0:  # no device ran: nothing to read
        return None
    if ctx.kind != "train" or not ctx.units:
        return None
    return 1e3 * ctx.layer_s.get("dense", 0.0) / ctx.units
