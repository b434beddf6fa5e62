"""Real (unpadded) samples trained per second over the window: every
window round's samples over the time from its first round's start to
its last round's end (host clock)."""


def read(ctx):
    if ctx.count_unit != "samples":
        return None
    return ctx.units / ctx.window_s
