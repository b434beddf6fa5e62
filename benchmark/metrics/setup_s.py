"""Seconds from the process's start to the window's: imports, data and
variables from the seed, the simulation's construction, kernel builds
and the first rounds (host clock)."""


def read(ctx):
    return ctx.setup_s
