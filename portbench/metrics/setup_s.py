"""Seconds from the process's start to the first timed fit: imports,
kernel build or load, inputs, the warm-up fit of the cell's shapes with
its graph captures and first calls (host clock)."""


def read(ctx):
    return ctx.setup_s
