"""serve_device_ms_per_frame: the card's busy time in the traced window
over the frames served. Device layer."""


def read(name, ctx):
    if ctx.trace is None or not ctx.result.units:
        return None
    return ctx.trace.busy_s() * 1e3 / ctx.result.units
