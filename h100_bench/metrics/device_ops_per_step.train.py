"""Device ops (kernels, memcpys, memsets) per train step in the trace."""


def read(ctx):
    if ctx.device_ops == 0:  # no device ran: nothing to read
        return None
    if ctx.kind != "train" or not ctx.units:
        return None
    return ctx.device_ops / ctx.units
