"""setup_s (host clock): everything before the window, from the start of
the benchmark's process: imports, the kernel library's load (or build),
weights and inputs, calibration and quantization, and the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
