"""The whole network in bf16: bf16 weights and activations, float32 sums.
The program's ``models.unet.load_unet`` under ``make_denoise_fn``, beside
the plain reference's bf16 network. No mix keys."""

# the precision each part of the forward runs in (``harness/counts.py``)
MODES = {"inc": "bf16", "blocks": "bf16", "up": "bf16", "head": "bf16"}


def program(arch, mix, inputs, params, schedule):
    """The program's ``(x_t, t) → prediction`` on [x_t, cond]."""
    import torch

    from s1s2_torch.models.unet import load_unet
    from s1s2_torch.sampling.samplers import make_denoise_fn

    net = load_unet(params, arch["out_ch"], arch["base_ch"], arch["stem_s2d"],
                    in_ch=arch["in_ch"], compute_dtype=torch.bfloat16, device=inputs.gt.device)
    return make_denoise_fn(net, inputs.cond)


def reference(arch, mix, inputs, ab64):
    """cond rows → the reference's ``(x_t, t) → prediction`` on them."""
    from benchmark.reference import model

    return lambda cond: model.denoiser(inputs.params, arch["stem_s2d"], cond)
