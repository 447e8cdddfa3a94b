"""DPM-Solver++(2M) down a round-unique grid (``grid``: t_hi, steps, T),
from gt diffused to the grid's top with the call's noise; one denoiser
call a step and a last one at the grid's bottom, the final x0 estimate
clamped to [0, 1]. The program's ``sampling.dpm_solver.dpm_solver_2m``
beside the plain reference's. Mix key: ``grid``."""


def forwards(mix):
    """Denoiser calls in one call."""
    from benchmark.reference.sampling import round_unique_grid

    return len(round_unique_grid(*mix["grid"]))


def program(denoise, gt, schedule, mix, prediction):
    """The timed call: noise → the batch's outputs."""
    import numpy as np

    from s1s2_torch.core.parametrize import Parameterization, q_sample
    from s1s2_torch.sampling import grids
    from s1s2_torch.sampling.dpm_solver import dpm_solver_2m

    grid = grids.round_unique_grid(*mix["grid"])
    param = Parameterization(prediction)
    ab = schedule.alpha_bar_np()
    K = int(grid[-1])
    sab, s1m = float(np.sqrt(ab[K])), float(np.sqrt(np.float32(1.0) - ab[K]))
    return lambda noise: dpm_solver_2m(denoise, q_sample(gt, noise, sab, s1m), schedule, grid,
                                       param)


def reference(denoise, gt, noise, ab64, mix, prediction):
    """The plain reference's outputs for these rows."""
    from benchmark.reference import sampling

    return sampling.dpm_solver_2m(denoise, gt, noise, ab64,
                                  sampling.round_unique_grid(*mix["grid"]), prediction)
