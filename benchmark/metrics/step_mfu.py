"""step_mfu (device trace), in %: the model's operations in the traced
window's calls, each counted from the shapes and taken at the published
peak of the precision it runs in (``harness/counts.py``: int8 convs at the
int8 peak, every other layer at the bf16 peak), over the traced window's
length. Counts the algorithm's work, whatever implements it."""

from benchmark.harness.counts import peak_seconds


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    per_forward = sum(peak_seconds(layer) for layer in ctx["layers"])
    return 100.0 * per_forward * ctx["forwards_per_call"] * ctx["window"].calls / tr.window_s
