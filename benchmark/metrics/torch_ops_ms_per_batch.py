"""torch_ops_ms_per_batch (device trace): device time a call of every
device operation in the traced window that is not one of the program's own
kernels (the ``__global__`` functions of ``s1s2_torch``'s CUDA sources):
PyTorch's own kernels, copies and fills."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops or not ctx["window"].calls:
        return None
    own = ctx["program_kernels"]
    sec = sum(s for name, s, _ in tr.ops if not any(k in name for k in own))
    return 1e3 * sec / ctx["window"].calls
