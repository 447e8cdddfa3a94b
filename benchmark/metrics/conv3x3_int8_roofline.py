"""conv3x3_int8_roofline (device trace), in %: the int8 3x3 convs' least
time (``harness/counts.py``: the larger of their operations at the int8
peak and their bytes at HBM speed, bf16 input read once) over the device
time of the kernels below in the traced window. The int8 conv's work
includes quantizing its bf16 input, so its quantize pass is summed too."""

from benchmark.harness.counts import roofline_percent

KERNELS = ("conv3x3_int8_kernel", "quantize_pad_kernel")


def read(ctx):
    return roofline_percent(ctx, KERNELS, "conv3x3", "int8")
