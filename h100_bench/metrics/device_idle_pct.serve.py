"""100 x (1 - the union of device op intervals over the traced serve
window's length)."""


def read(ctx):
    if ctx.device_ops == 0:  # no device ran: nothing to read
        return None
    if ctx.kind != "serve" or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
