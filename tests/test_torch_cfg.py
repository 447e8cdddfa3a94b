"""s1s2_torch's guided generation against the JAX package on the same numpy
inputs: the stacked CFG denoisers (bf16 and int8), per-channel calibration
and its folded int8 weights, ``bf16_blocks``, the rollout calibration in
both families, the linspace scan's trajectory and the int8 artifact
(``save_quant``/``load_quant``) across the two packages. The model is the
committed cfg_v teacher (base 96, trained weights: the model the CFG line
runs) at 16².

Two bf16 nets that round at other places (the port's conv rounds once, the
JAX conv its product and its bias add separately) differ by about as much
as either differs from the exact f32 result, and guidance (3·pc − 2·pu)
amplifies both alike; so the port's outputs are held within the JAX
package's own error against its f32 net: mean |port − JAX| ≤ mean |JAX −
JAX f32|, for bf16 and for int8."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from s1s2.core import Schedule as JSchedule
from s1s2.models import UNetSmall as JUNet
from s1s2.models import quant as jq
from s1s2.sampling import samplers as js
from s1s2.sampling.grids import round_unique_grid
from s1s2_torch.core import random
from s1s2_torch.core.schedule import Schedule
from s1s2_torch.models import quant as tq
from s1s2_torch.models.unet import load_unet
from s1s2_torch.models.weights import params_from_numpy
from s1s2_torch.sampling import samplers as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "examples", "checkpoints", "cfg_v_teacher.bf16.msgpack")
B, H, C, BASE, G = 2, 16, 4, 96, 3.0
GRID = round_unique_grid(999, 5, 1000)
T_EVAL = np.array([999, 500], np.int32)


def _jname(name):
    return name.replace(".", "/")


@pytest.fixture(scope="module")
def case():
    with open(CKPT, "rb") as f:
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      serialization.msgpack_restore(f.read()))
    state = params_from_numpy(tree)
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((B, H, H, C)).astype(np.float32)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    jm = JUNet(out_ch=C, base_ch=BASE, compute_dtype=jnp.bfloat16)
    f32 = js.make_cfg_denoise_fn(JUNet(out_ch=C, base_ch=BASE, compute_dtype=jnp.float32).apply,
                                 {"params": tree}, jnp.asarray(cond), G)
    return dict(state=state, tree=tree, cond=cond, x=x, jm=jm,
                model=load_unet(state, C, BASE, 1, device="cpu"),
                f32=np.asarray(f32(jnp.asarray(x), jnp.asarray(T_EVAL))),
                S=JSchedule.cosine(1000), St=Schedule.cosine(1000))


def test_cfg_denoise_fn_against_jax(case):
    """One stacked forward of 2B rows, within the JAX bf16 net's own error
    against f32; cond = null-cond gives the unguided prediction exactly."""
    ref = np.asarray(js.make_cfg_denoise_fn(case["jm"].apply, {"params": case["tree"]},
                                            jnp.asarray(case["cond"]), G)(
        jnp.asarray(case["x"]), jnp.asarray(T_EVAL)))
    fn = ts.make_cfg_denoise_fn(case["model"], torch.from_numpy(case["cond"]), G)
    got = fn(torch.from_numpy(case["x"]), torch.from_numpy(T_EVAL)).numpy()
    assert got.shape == ref.shape == (B, H, H, C)
    assert np.abs(got - ref).mean() <= np.abs(ref - case["f32"]).mean()
    plain = ts.make_denoise_fn(case["model"], torch.from_numpy(case["cond"]))(
        torch.from_numpy(case["x"]), torch.from_numpy(T_EVAL))
    same = ts.make_cfg_denoise_fn(case["model"], torch.from_numpy(case["cond"]), G,
                                  null_cond=torch.from_numpy(case["cond"]))(
        torch.from_numpy(case["x"]), torch.from_numpy(T_EVAL))
    assert torch.equal(same, plain)


_PAIRS = {}


def _calib_pair(case, **kw):
    """The same calibration batches (the port's q_sample ones, null twins)
    through both packages' quantize_unet (made once per option set)."""
    key = tuple(sorted(kw.items()))
    if key not in _PAIRS:
        _PAIRS[key] = _make_calib_pair(case, **kw)
    return _PAIRS[key]


def _make_calib_pair(case, **kw):
    ab = case["S"].alpha_bar_np()
    tcal = tq.make_sampler_calib(torch.from_numpy(case["x"]).clamp(0, 1),
                                 torch.from_numpy(case["cond"]), ab, (999, 200, 20),
                                 null_cond=True)
    jcal = [(jnp.asarray(x.numpy()), jnp.asarray(t.numpy())) for x, t in tcal]
    jqp = jq.quantize_unet(case["tree"], jcal, base_ch=BASE, **kw)
    tqp = tq.quantize_unet(case["state"], tcal, base_ch=BASE, **kw)
    return tcal, jqp, tqp


def test_sampler_calib_null_cond_twins(case):
    tcal, _, _ = _calib_pair(case)
    assert len(tcal) == 6
    for (xc, tc), (xn, tn) in zip(tcal[0::2], tcal[1::2]):
        assert torch.equal(xc[..., :C], xn[..., :C]) and torch.equal(tc, tn)
        assert not xn[..., C:].any() and torch.equal(xc[..., C:], torch.from_numpy(case["cond"]))


def test_per_channel_calibration(case):
    """(Ci,) scales for every conv and up-conv input, within the recorded
    bf16 calibration deviation (test_torch_quant.py's bounds) taken per
    channel against the tensor's range: a value's bf16 rounding differences
    scale with the magnitudes summed into it, set by the whole tensor, so a
    channel of small range can differ by more than its own 2^-5. The first
    block's input is one conv deep: every channel within 2^-7 of the
    tensor's largest scale; deeper inputs within 2^-5."""
    _, jqp, tqp = _calib_pair(case, act_perchannel=True)
    assert sorted(map(_jname, tqp.act_scale)) == sorted(jqp.act_scale)
    for k, v in tqp.act_scale.items():
        ref = np.asarray(jqp.act_scale[_jname(k)])
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
        assert tuple(v.shape) == ref.shape == (case["state"][f"{k}.kernel"].shape[2],)
        d = np.abs(v.numpy() - ref) / ref.max()
        assert d.max() <= (2.0 ** -7 if k == "down1.conv1" else 2.0 ** -5), (k, d.max())


def test_per_channel_folded_weights_bit_equal(case):
    """Given the same per-channel scales, the folded int8 weights, their sw
    and the biases are bit-equal to the JAX package's; deq is sw alone."""
    _, jqp, _ = _calib_pair(case, act_perchannel=True)
    scales = {k.replace("/", "."): torch.from_numpy(np.asarray(v))
              for k, v in jqp.act_scale.items()}
    w8, bias = tq.quantize_weights(case["state"], act_scales=scales)
    assert sorted(map(_jname, w8)) == sorted(jqp.w8)
    for name, (q, sw) in w8.items():
        jw, jsw = jqp.w8[_jname(name)]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
        np.testing.assert_array_equal(bias[name].numpy(), np.asarray(jqp.bias[_jname(name)]))
    qp = tq.QuantParams(case["state"], w8, bias, scales, C, BASE, 1, act_perchannel=True)
    assert all(torch.equal(qp.deq[k], w8[k][1]) for k in w8)


def _same_scales(jqp, tqp):
    return {k: (torch.from_numpy(np.asarray(jqp.act_scale[_jname(k)])) if tqp.act_perchannel
                else float(jqp.act_scale[_jname(k)])) for k in tqp.act_scale}


@pytest.mark.parametrize("kw", [{}, {"act_perchannel": True},
                                {"act_perchannel": True, "bf16_blocks": ("conv1",)}],
                         ids=["per_tensor", "per_channel", "per_channel_bf16_conv1"])
def test_quant_cfg_denoise_fn_against_jax(case, kw):
    """The stacked int8 CFG denoiser with JAX's scales (the weights folded
    with them), within the JAX int8 net's own error against f32.
    ``bf16_blocks`` leaves conv1 out of w8."""
    _, jqp, tqp = _calib_pair(case, **kw)
    scales = _same_scales(jqp, tqp)
    w8, bias = tq.quantize_weights(case["state"],
                                   act_scales=scales if tqp.act_perchannel else None,
                                   bf16_blocks=kw.get("bf16_blocks", ()))
    assert sorted(map(_jname, w8)) == sorted(jqp.w8)
    if "bf16_blocks" in kw:
        assert not any(k.startswith("conv1.") for k in w8) and len(w8) == 10
    same = tq.QuantParams(case["state"], w8, bias, scales, C, BASE, 1, tqp.act_perchannel)
    ref = np.asarray(jq.make_quant_cfg_denoise_fn(jqp, jnp.asarray(case["cond"]), G)(
        jnp.asarray(case["x"]), jnp.asarray(T_EVAL)))
    got = tq.make_quant_cfg_denoise_fn(same, torch.from_numpy(case["cond"]), G)(
        torch.from_numpy(case["x"]), torch.from_numpy(T_EVAL)).numpy()
    assert np.isfinite(got).all() and got.shape == (B, H, H, C)
    assert np.abs(got - ref).mean() <= np.abs(ref - case["f32"]).mean()


def _within_own_error(got, ref, ref_f32):
    """Each state: mean |port − JAX| ≤ mean |JAX − JAX f32|."""
    for g, r, r32 in zip(got, ref, ref_f32):
        g, r, r32 = np.asarray(g), np.asarray(r), np.asarray(r32)
        assert np.isfinite(g).all() and np.abs(g - r).mean() <= np.abs(r - r32).mean()


def _jax_f32(case):
    return JUNet(out_ch=C, base_ch=BASE, compute_dtype=jnp.float32).apply


def test_linspace_scan_trajectory_against_jax(case):
    """``return_traj`` of the ε linspace scan, 5 steps from t=999: the int32
    timesteps equal, the first state the init itself, the others within the
    JAX bf16 walk's own error against its f32 walk."""
    cond = jnp.asarray(case["cond"])
    walks = [js._ddim_linspace_scan(js.make_denoise_fn(apply, {"params": case["tree"]}, cond),
                                    jnp.asarray(case["x"]), case["S"], 999, 5, (0.0, 1.0),
                                    return_traj=True)
             for apply in (case["jm"].apply, _jax_f32(case))]
    (rx, (rts, rtraj)), (_, (_, rtraj32)) = walks
    tfn = ts.make_denoise_fn(case["model"], torch.from_numpy(case["cond"]))
    gx, (gts, gtraj) = ts._ddim_linspace_scan(tfn, torch.from_numpy(case["x"]), case["St"],
                                              999, 5, (0.0, 1.0), return_traj=True)
    assert gts.dtype == torch.int32 and gts.tolist() == np.asarray(rts).tolist()
    assert tuple(gtraj.shape) == np.asarray(rtraj).shape == (5, B, H, H, C)
    np.testing.assert_array_equal(gtraj[0].numpy(), case["x"])
    _within_own_error(gtraj[1:].numpy(), np.asarray(rtraj)[1:], np.asarray(rtraj32)[1:])
    assert torch.equal(gx, ts._ddim_linspace_scan(tfn, torch.from_numpy(case["x"]),
                                                  case["St"], 999, 5, (0.0, 1.0)))


@pytest.mark.parametrize("param,eps_linspace", [("v", None), ("eps", (999, 5)), ("eps", None)])
def test_cfg_rollout_calib_against_jax(case, param, eps_linspace):
    """Both families' guided rollouts from the same key (``PRNGKey(5)``, no
    split), in the JAX order (cond, then its zeroed-cond twin, per step):
    timesteps and conds equal; the first state, the host draw of the
    reference's bits, bit-equal; the others within the JAX bf16 rollout's
    own error against its f32 rollout."""
    kw = dict(param=param, n=B, out_ch=C, eps_linspace=eps_linspace)
    ref, ref32 = (jq.make_cfg_rollout_calib(apply, {"params": case["tree"]},
                                            jnp.asarray(case["cond"]), case["S"], GRID, G, **kw)
                  for apply in (case["jm"].apply, _jax_f32(case)))
    got = tq.make_cfg_rollout_calib(case["model"], torch.from_numpy(case["cond"]), case["St"],
                                    GRID, G, **kw)
    assert len(got) == len(ref) == 2 * len(GRID)
    for i, ((gx, gt_), (rx, rt)) in enumerate(zip(got, ref)):
        assert gt_.tolist() == np.asarray(rt).tolist()
        np.testing.assert_array_equal(gx[..., C:].numpy(), np.asarray(rx)[..., C:])
        if i < 2:
            np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    _within_own_error([g[0][..., :C].numpy() for g in got[2:]],
                      [np.asarray(r[0])[..., :C] for r in ref[2:]],
                      [np.asarray(r[0])[..., :C] for r in ref32[2:]])


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_save_quant_loads_across_packages(case, tmp_path, per_channel):
    """An artifact written by either package loads in the other with equal
    tensors: the param tree, the int8 weights and sw, the biases, the scales
    (0-d ones as floats of their f32 value) and the metadata."""
    _, jqp, tqp = _calib_pair(case, act_perchannel=per_channel,
                              bf16_blocks=("conv1",) if per_channel else ())
    jq.save_quant(jqp, str(tmp_path / "jax.msgpack"))
    tq.save_quant(tqp, str(tmp_path / "port.msgpack"))
    port_from_jax = tq.load_quant(str(tmp_path / "jax.msgpack"))
    jax_from_port = jq.load_quant(str(tmp_path / "port.msgpack"))
    for qp_t, qp_j in ((port_from_jax, jqp), (tqp, jax_from_port)):
        assert (qp_t.out_ch, qp_t.base_ch, qp_t.stem_s2d, qp_t.act_perchannel) == (
            qp_j.out_ch, qp_j.base_ch, qp_j.stem_s2d, qp_j.act_perchannel)
        assert sorted(map(_jname, qp_t.w8)) == sorted(qp_j.w8)
    # port ← JAX: every tensor equal to the JAX package's own
    flat = params_from_numpy(jax.tree_util.tree_map(np.asarray, jqp.params))
    assert set(port_from_jax.params) == set(flat)
    for k, v in port_from_jax.params.items():
        assert torch.equal(v, flat[k]), k
    for k, (q, s) in port_from_jax.w8.items():
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqp.w8[_jname(k)][0]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(jqp.w8[_jname(k)][1]))
        np.testing.assert_array_equal(port_from_jax.bias[k].numpy(),
                                      np.asarray(jqp.bias[_jname(k)]))
    for k, v in port_from_jax.act_scale.items():
        ref = np.asarray(jqp.act_scale[_jname(k)], np.float32)
        assert isinstance(v, torch.Tensor) == per_channel
        np.testing.assert_array_equal(np.asarray(v, np.float32), ref)
    # JAX ← port: every tensor equal to the port's own
    for k, v in tqp.params.items():
        node = jax_from_port.params
        for p in k.split("."):
            node = node[p]
        np.testing.assert_array_equal(np.asarray(node), v.numpy())
    for k, (q, s) in tqp.w8.items():
        np.testing.assert_array_equal(np.asarray(jax_from_port.w8[_jname(k)][0]), q.numpy())
        np.testing.assert_array_equal(np.asarray(jax_from_port.w8[_jname(k)][1]), s.numpy())
    for k, v in tqp.act_scale.items():
        np.testing.assert_array_equal(np.asarray(jax_from_port.act_scale[_jname(k)], np.float32),
                                      np.asarray(v, np.float32))
    # the port's own round trip serves the same int8 forward (a per-tensor
    # scale comes back as its f32 value, as in the JAX package)
    back = tq.load_quant(str(tmp_path / "port.msgpack"))
    xin = torch.from_numpy(np.concatenate([case["x"], case["cond"]], -1))
    t = torch.from_numpy(T_EVAL)
    if not per_channel:
        tqp = tq.QuantParams(tqp.params, tqp.w8, tqp.bias,
                             {k: float(np.float32(v)) for k, v in tqp.act_scale.items()},
                             C, BASE, 1)
    assert torch.equal(tq.quant_apply(back, xin, t), tq.quant_apply(tqp, xin, t))


def test_quant_params_per_channel_to_device(case):
    _, _, tqp = _calib_pair(case, act_perchannel=True)
    copy = tqp.to("cpu")
    assert copy.act_perchannel and all(
        torch.equal(copy.act_scale[k], tqp.act_scale[k]) for k in tqp.act_scale)
    assert all(torch.equal(copy.sx[k], tqp.sx[k]) for k in tqp.sx)


def test_rollout_draw_is_the_reference_bits(case):
    """The rollout's start noise: ``normal(PRNGKey(5), (n, H, W, out_ch))``
    times the f32 scale √(1−ᾱ_K), no split."""
    got = tq.make_cfg_rollout_calib(case["model"], torch.from_numpy(case["cond"]), case["St"],
                                    GRID, G, param="v", n=B, out_ch=C)
    ab = case["St"].alpha_bar_np()
    scale = np.float32(np.sqrt(np.float32(1.0) - ab[int(GRID[-1])]))
    want = random.normal(random.PRNGKey(5), (B, H, H, C)) * scale
    np.testing.assert_array_equal(got[0][0][..., :C].numpy(), want)
