"""``device.idle_share.<cell kind>``: the share of the traced window in
which no kernel, copy or memset ran on the card, %, on the union of the
device's intervals."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
