"""The int4 control of the int8 cells: the plain reference's int8 network
quantized at 7 instead of 127, put in the program's place. The program has
no int4 path, so this denoiser has a reference only."""

from benchmark.harness.traffic import plugin

MODES = plugin("denoisers", "int8").MODES
QMAX = 7


def reference(arch, mix, inputs, ab64):
    """cond rows → the int4 network's ``(x_t, t) → prediction`` on them."""
    return plugin("denoisers", "int8").reference(arch, mix, inputs, ab64, qmax=QMAX)
