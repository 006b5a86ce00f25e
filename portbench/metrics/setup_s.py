"""setup_s (host clock): from the start of the process to the opening of
the measured window: imports, the kernel build (cached in the checkout's
``build/repro_torch``), the weights made on the device from the seed,
the program's construction and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
