"""batch_ms_p95 (device clock): the 95th percentile over every call of the
window of the time between the CUDA events recorded after consecutive
calls, dispatched ahead with no sync between them."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx["window"].per_call_ms, 95))
