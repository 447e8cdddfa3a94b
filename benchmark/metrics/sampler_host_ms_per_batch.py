"""sampler_host_ms_per_batch (program span): host ms a window call in the
sampler's own spans (``sampler.call``, ``sampler.step``, ``q_sample``),
their children left out: the coefficients, their copies to the card, and
the plain PyTorch updates between denoiser calls (``harness/spans.py``)."""

from benchmark.harness.spans import per_call


def read(ctx):
    v = per_call(ctx)
    return None if v is None else v["sampler"]
