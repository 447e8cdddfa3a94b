"""host_syncs_per_batch (program counter): the host–device
synchronizations a window call, counted by the program's sync counter in
all of its spans (``harness/spans.py``) in the traced window: each one
drains the card's queue before the host dispatches on."""

from benchmark.harness.spans import per_call


def read(ctx):
    v = per_call(ctx)
    return None if v is None else v["syncs"]
