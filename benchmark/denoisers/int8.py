"""The double-conv blocks in int8 (static per-tensor activation scales,
per-output-channel weight scales, int32 sums), the stem conv, up-convs and
head in bf16; calibrated at ``calib_t`` on the first ``calib_n`` rows. The
program's ``models.quant.quantize_unet`` (calibrated by
``make_sampler_calib``) under ``make_quant_denoise_fn``, beside the plain
reference's quantized network, whose scales and weights are worked out
again from the benchmark's weights and calibration inputs. Mix keys:
``calib_t``, ``calib_n``."""

# the precision each part of the forward runs in (``harness/counts.py``)
MODES = {"inc": "bf16", "blocks": "int8", "up": "bf16", "head": "bf16"}
QMAX = 127


def program(arch, mix, inputs, params, schedule):
    """The program's ``(x_t, t) → prediction`` on [x_t, cond]."""
    from s1s2_torch.models.quant import (make_quant_denoise_fn, make_sampler_calib,
                                         quantize_unet)

    calib = make_sampler_calib(inputs.gt, inputs.cond, schedule.alpha_bar_np(),
                               tuple(mix["calib_t"]), n=int(mix["calib_n"]),
                               noises=inputs.calib_noise)
    net = quantize_unet(params, calib, out_ch=arch["out_ch"], base_ch=arch["base_ch"],
                        stem_s2d=arch["stem_s2d"])
    return make_quant_denoise_fn(net, inputs.cond)


def reference(arch, mix, inputs, ab64, qmax=QMAX, block=8):
    """cond rows → the reference's ``(x_t, t) → prediction`` on them, the
    blocks quantized at ``qmax``."""
    import numpy as np
    import torch

    from benchmark.reference import model, sampling

    ab = ab64.astype(np.float32)
    n = int(mix["calib_n"])
    batches = []
    for tval, eps in zip(mix["calib_t"], inputs.calib_noise):
        a = np.float32(ab[tval])
        x_t = sampling.q_sample(inputs.gt[:n], eps, float(np.sqrt(a)),
                                float(np.sqrt(np.float32(1.0) - a)))
        batches.append((torch.cat([x_t, inputs.cond[:n]], dim=-1), int(tval)))
    absmax = model.calibrate(inputs.params, arch["stem_s2d"], batches, rows=block)
    quant = model.Quant(inputs.params, absmax, qmax)
    return lambda cond: model.denoiser(inputs.params, arch["stem_s2d"], cond, quant)
