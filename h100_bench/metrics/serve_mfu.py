"""The eval forward's model operations (``flops.model_flops``) at the
window's request rate, over the configuration's dense peak."""


def read(ctx):
    if ctx.device_ops == 0:  # no device ran: nothing to read
        return None
    if ctx.kind != "serve":
        return None
    return 100.0 * ctx.flops_per_unit * ctx.rate / ctx.peak_flops
