"""model_host_ms_per_batch (program span): host ms a window call in
``model.forward`` spans, their ``kernel.*`` children left out: the
``[x_t, cond]`` cat and the network's PyTorch glue (casts, pools, cats,
up-convs, head) (``harness/spans.py``)."""

from benchmark.harness.spans import per_call


def read(ctx):
    v = per_call(ctx)
    return None if v is None else v["model"]
