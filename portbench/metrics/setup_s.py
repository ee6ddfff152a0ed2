"""Set-up seconds: from process start to the window (imports, CUDA init,
the kernels and codec from the build cache, writing the input, the System
and runner, load_device where the cell has one, the warm-up)."""

NAME, UNIT, BETTER, SOURCE = "setup_s", "s", "lower", "host_clock"


def read(ctx):
    return ctx.setup_s
