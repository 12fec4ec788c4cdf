"""setup_s: process start to the window's start: imports, the kernel
library (built on a cold checkout), the dataset, the runner and the warm-up
of the cell's own step kinds."""


def read(ctx):
    return ctx["setup_s"]
