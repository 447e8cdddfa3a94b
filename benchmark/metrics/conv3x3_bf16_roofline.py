"""conv3x3_bf16_roofline (device trace), in %: the bf16 3x3 convs' least
time (``harness/counts.py``: the larger of their operations at the bf16
peak and their bytes at HBM speed, the stems' true channel counts) over
the device time of the kernels below in the traced window."""

from benchmark.harness.counts import roofline_percent

KERNELS = ("conv3x3_bf16_kernel",)


def read(ctx):
    return roofline_percent(ctx, KERNELS, "conv3x3", "bf16")
