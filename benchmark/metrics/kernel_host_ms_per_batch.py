"""kernel_host_ms_per_batch (program span): host ms a window call inside
the ``kernel.<wrapper>`` spans of ``s1s2_torch/ops``: checks, the
packed-weight lookup, scratch allocation and the launch
(``harness/spans.py``)."""

from benchmark.harness.spans import per_call


def read(ctx):
    v = per_call(ctx)
    return None if v is None else v["kernel"]
