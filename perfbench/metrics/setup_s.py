"""``setup_s``: seconds from the process's start to the window's first
call: imports, the card's context, the kernels' build (the first run of a
checkout compiles), inputs and weights from the seed, warm-up (host
clock)."""


def read(run):
    return run.setup_s
