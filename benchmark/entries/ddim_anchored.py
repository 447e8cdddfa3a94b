"""GT-anchored DDIM: gt diffused to ``t_start`` with the call's noise, then
``steps`` DDIM steps down a truncating linspace grid, the last x0 estimate
clamped to [0, 1]. The program's ``sampling.samplers.ddim_anchored`` (ε
models only) beside the plain reference's. Mix keys: ``t_start``,
``steps``."""


def forwards(mix):
    """Denoiser calls in one call."""
    return int(mix["steps"])


def program(denoise, gt, schedule, mix, prediction):
    """The timed call: noise → the batch's outputs."""
    if prediction != "eps":
        raise ValueError(f"the program's ddim_anchored samples ε models, not {prediction!r}")
    from s1s2_torch.sampling.samplers import ddim_anchored

    t_start, steps = int(mix["t_start"]), int(mix["steps"])
    return lambda noise: ddim_anchored(denoise, gt, schedule, t_start, steps, noise=noise)


def reference(denoise, gt, noise, ab64, mix, prediction):
    """The plain reference's outputs for these rows."""
    from benchmark.reference import sampling

    return sampling.ddim_anchored(denoise, gt, noise, ab64, int(mix["t_start"]),
                                  int(mix["steps"]), prediction)
