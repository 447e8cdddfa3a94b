"""The port's training loop around the step (s1s2_torch.train.trainer,
data.loader.batch_iterator, train.checkpoint's model and state files,
utils.profiling, cli.train, tools.bench_train) against the JAX package's,
on a tiny synthetic set (base 8, 32², B=2), in f32.

The JAX trainer's eager flax init (over 20 s on a CPU) is replaced
in these tests by the same bits from the port's ``init_params``, which
``tests/test_torch_random.py`` holds bit-equal to flax's; both trainers
then start from one set of weights. Tolerances: the epoch losses within
1e-5 relative and the EMA weights within 1e-6 relative (the f32 step's
bound, ``tests/test_torch_train.py``, measured at ≤ 1e-6 there; JAX's batch
is sharded over two of the test run's virtual devices, which sums in
another order)."""

import argparse
import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict, unflatten_dict

from s1s2.cli import train as jcli
from s1s2.data.dataset import NpzPatchDataset as JDataset
from s1s2.data.loader import batch_iterator as j_batch_iterator
from s1s2.models import UNetSmall as JUNet
from s1s2.train import checkpoint as jckpt
from s1s2.train import loop as jloop
from s1s2.train import trainer as jtrainer
from s1s2_torch.__main__ import main as dispatch
from s1s2_torch.cli import train as cli
from s1s2_torch.data.dataset import NpzPatchDataset
from s1s2_torch.data.loader import batch_iterator
from s1s2_torch.data.synthetic import make_synthetic_patches
from s1s2_torch.models.unet import init_params
from s1s2_torch.tools import bench_train
from s1s2_torch.train import checkpoint, loop, trainer
from s1s2_torch.utils import profiling

BASE, SIZE, BATCH, FILES, EPOCHS = 8, 32, 2, 6, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small convs; the test run has a worker a core
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def patches(tmp_path_factory):
    d = tmp_path_factory.mktemp("patches")
    make_synthetic_patches(str(d / "p"), n=FILES, size=SIZE, seed=0)
    return str(d / "p")


def run_kw(patches, out, **kw):
    return {**dict(patch_dir=patches, model_path=str(out / "m.msgpack"), epochs=EPOCHS,
                   batch_size=BATCH, base_ch=BASE, seed=5, compute_dtype="float32"), **kw}


def port_run(patches, out, **kw):
    return trainer.train_loop(trainer.RunConfig(**run_kw(patches, out, device="cpu", **kw)),
                              loop.TrainConfig(T=1000))


@pytest.fixture(scope="module")
def both(patches, tmp_path_factory):
    """One 2-epoch run of each trainer from the same weights."""
    out = tmp_path_factory.mktemp("runs")
    jparams = unflatten_dict({tuple(k.split(".")): jnp.asarray(v.numpy())
                              for k, v in init_params(4, BASE, 1, seed=5, in_ch=8).items()})
    mp = pytest.MonkeyPatch()
    mp.setattr(JUNet, "init", lambda self, *a, **k: {"params": jparams})
    try:
        jh = jtrainer.train_loop(jtrainer.RunConfig(**run_kw(patches, out / "jax")),
                                 jloop.TrainConfig(T=1000))
    finally:
        mp.undo()
    ph = port_run(patches, out / "port", metrics_jsonl=str(out / "port" / "m.jsonl"))
    return jh, ph, out


def test_train_loop_matches_jax(both):
    jh, ph, _ = both
    np.testing.assert_allclose(ph["epoch_loss"], jh["epoch_loss"], rtol=1e-5)
    assert ph["skipped"] == jh["skipped"] == 0
    assert ph["best_loss"] == min(ph["epoch_loss"])
    np.testing.assert_allclose(ph["best_loss"], jh["best_loss"], rtol=1e-5)
    assert ph["final_state"].step == jh["final_state"].step.item() == EPOCHS * (FILES // BATCH)


@pytest.mark.parametrize("which", ["final", "last", "best"])
def test_saved_ema_files_read_both_ways(both, which):
    """Each trainer's model files load in the other package, and hold the
    same EMA weights."""
    _, ph, out = both
    i = ("final", "last", "best").index(which)
    jpath = jckpt.reference_artifact_paths(str(out / "jax" / "m.msgpack"))[i]
    ppath = checkpoint.reference_artifact_paths(str(out / "port" / "m.msgpack"))[i]
    template = init_params(4, BASE, 1, seed=0, in_ch=8)
    j_in_port = checkpoint.load_model(template, jpath)
    jtemplate = unflatten_dict({tuple(k.split(".")): np.zeros(v.shape, np.float32)
                                for k, v in template.items()})
    with open(ppath, "rb") as f:
        p_in_flax = flatten_dict(serialization.from_bytes(jtemplate, f.read()))
    for k, v in j_in_port.items():
        a = np.asarray(p_in_flax[tuple(k.split("."))])
        assert a.dtype == np.float32 and a.shape == tuple(v.shape)
        np.testing.assert_allclose(a, v.numpy(), rtol=1e-6, atol=1e-7)
    assert os.path.exists(str(out / "port" / "m_best.msgpack.loss.json"))


def test_save_model_writes_flaxs_bytes(tmp_path):
    params = init_params(4, BASE, 1, seed=1, in_ch=8)
    tree = unflatten_dict({tuple(k.split(".")): v.numpy() for k, v in params.items()})
    jckpt.save_model(tree, str(tmp_path / "j.msgpack"))
    checkpoint.save_model(params, str(tmp_path / "p.msgpack"))
    assert (tmp_path / "j.msgpack").read_bytes() == (tmp_path / "p.msgpack").read_bytes()


def test_load_model_refuses_another_architecture(tmp_path):
    checkpoint.save_model(init_params(4, BASE, 1, seed=1, in_ch=8), str(tmp_path / "m.msgpack"))
    with pytest.raises(ValueError, match="does not match the model architecture"):
        checkpoint.load_model(init_params(4, 16, 1, seed=1, in_ch=8), str(tmp_path / "m.msgpack"))


def test_load_any_checkpoint_dispatches(both, tmp_path):
    _, ph, out = both
    template = init_params(4, BASE, 1, seed=0, in_ch=8)
    path = str(out / "port" / "m.msgpack")
    got = checkpoint.load_any_checkpoint(path, template)
    assert set(got) == set(template)
    with pytest.raises(ValueError, match="template"):
        checkpoint.load_any_checkpoint(path)
    pth = checkpoint.load_any_checkpoint("examples/ref_crossval/ref_eps_model.pth")
    assert set(pth) == {"params"}
    state = ph["final_state"]
    checkpoint.save_state(state, str(tmp_path / "st"))
    tree = checkpoint.load_any_checkpoint(str(tmp_path / "st"))
    assert tree["step"] == state.step and set(tree) == {"step", "skipped", "params",
                                                        "opt_state", "ema_params"}
    ema = checkpoint.flatten(checkpoint.load_params(str(tmp_path / "st")))
    assert torch.equal(ema[("outc", "bias")], state.ema_tree()["outc.bias"])


def test_state_file_round_trips(both, tmp_path):
    _, ph, _ = both
    state = ph["final_state"]
    checkpoint.save_state(state, str(tmp_path / "st"))
    fresh = loop.create_train_state(init_params(4, BASE, 1, seed=0, in_ch=8),
                                    loop.TrainConfig())
    back = checkpoint.restore_state(str(tmp_path / "st"), template=fresh)
    assert back.step == state.step and back.layout == state.layout
    for a, b in ((back.params, state.params), (back.ema_params, state.ema_params),
                 (back.opt_state.mu, state.opt_state.mu), (back.opt_state.nu, state.opt_state.nu),
                 (back.opt_state.count, state.opt_state.count), (back.skipped, state.skipped)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.restore_state(str(tmp_path / "st"), template=loop.create_train_state(
            init_params(4, 16, 1, seed=0, in_ch=8), loop.TrainConfig()))


def test_resumed_run_equals_unbroken_run(patches, tmp_path):
    """One epoch, a resume, the second epoch: the same state, bit for bit, as
    two epochs in one go (same shuffle, same per-step draws)."""
    whole = port_run(patches, tmp_path / "a", save_state_dir=str(tmp_path / "a" / "st"))
    port_run(patches, tmp_path / "b", save_state_dir=str(tmp_path / "b" / "st"), epochs=1)
    events = []
    resumed = trainer.train_loop(trainer.RunConfig(**run_kw(
        patches, tmp_path / "b", device="cpu", save_state_dir=str(tmp_path / "b" / "st"),
        resume=True)), loop.TrainConfig(T=1000), progress=events.append)
    assert {"resumed_at_step": FILES // BATCH, "resumed_at_epoch": 2} in events
    a, b = whole["final_state"], resumed["final_state"]
    assert a.step == b.step and torch.equal(a.params, b.params)
    assert torch.equal(a.ema_params, b.ema_params) and torch.equal(a.opt_state.nu, b.opt_state.nu)
    assert resumed["epoch_loss"] == whole["epoch_loss"][1:]
    assert ((tmp_path / "a" / "m.msgpack").read_bytes()
            == (tmp_path / "b" / "m.msgpack").read_bytes())


def test_metrics_jsonl_has_a_line_an_epoch(both):
    _, ph, out = both
    lines = [json.loads(ln) for ln in (out / "port" / "m.jsonl").read_text().splitlines()]
    assert [ln["epoch"] for ln in lines] == list(range(1, EPOCHS + 1))
    assert [ln["avg_loss"] for ln in lines] == ph["epoch_loss"]
    assert all({"ts", "skipped", "epoch_time_s", "steps_per_sec"} <= set(ln) for ln in lines)


def test_profile_dir_traces_epoch_one(patches, tmp_path):
    port_run(patches, tmp_path, epochs=1, profile_dir=str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    assert trace["traceEvents"]


def test_step_timer_and_metrics_logger(tmp_path):
    timer = profiling.StepTimer()
    assert timer.tick() is None and timer.tick() > 0
    log = profiling.MetricsLogger(str(tmp_path / "d" / "m.jsonl"))
    log.log(a=1, b=np.float32(2.5))
    log.close()
    line = json.loads((tmp_path / "d" / "m.jsonl").read_text())
    assert line["a"] == 1 and line["b"] == 2.5 and "ts" in line


@pytest.mark.parametrize("case", [dict(shuffle=True, drop_last=True, epoch=0),
                                  dict(shuffle=True, drop_last=False, epoch=3),
                                  dict(shuffle=False, drop_last=False, epoch=1),
                                  dict(shuffle=True, drop_last=True, epoch=2, process_index=1,
                                       process_count=2)])
def test_batch_iterator_order_matches_jax(patches, case):
    kw = dict(case, seed=11)
    kw.setdefault("process_index", 0)
    kw.setdefault("process_count", 1)
    for batch_size in (2, 4):
        got = list(batch_iterator(NpzPatchDataset(patches), batch_size, **kw))
        want = list(j_batch_iterator(JDataset(patches), batch_size, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))


def test_batch_iterator_raises_a_worker_error(patches):
    class Broken(NpzPatchDataset):
        def __getitem__(self, i):
            if i == 3:
                raise OSError("unreadable patch")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="unreadable"):
        list(batch_iterator(Broken(patches), 1, shuffle=False))
    with pytest.raises(ValueError, match="divisible"):
        list(batch_iterator(NpzPatchDataset(patches), 3, process_count=2))


def _actions(parser):
    return {a.dest: (a.default, a.type, a.choices, a.required, a.nargs, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_cli_has_every_flag_and_default_of_the_jax_parser():
    port = _actions(cli.build_parser())
    assert port.pop("device") == ("cuda", None, None, False, None, "_StoreAction")
    assert port == _actions(jcli.build_parser())


@pytest.mark.parametrize("flags,error", [
    # a coordinator with no peers: init_process_group's own error, not swallowed
    (["--coordinator", "h:1"], "rank parameter missing"),
    # without a coordinator JAX's CLI ignores them, and so does the port's
    (["--num_processes", "2"], None), (["--process_id", "0"], None),
    # one process is a world of 1: too few devices, as JAX's make_mesh says
    (["--spatial_shard"], r"mesh 1x2x1 != 1 devices"),
    (["--model_shard", "2"], r"mesh 1x1x2 != 1 devices")])
def test_multi_device_flags_at_world_1(patches, tmp_path, flags, error):
    argv = ["--patch_dir", patches, "--model_path", str(tmp_path / "m.msgpack"), "--base_ch",
            str(BASE), "--batch_size", "2", "--epochs", "1", "--device", "cpu"] + flags
    if error is None:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)
        assert (tmp_path / "m.msgpack").is_file()
    else:
        with pytest.raises(ValueError, match=error):
            cli.main(argv)
        assert not (tmp_path / "m.msgpack").exists()


def test_cli_trains_on_the_cpu_through_the_dispatcher(patches, tmp_path, capsys):
    assert dispatch(["train", "--patch_dir", patches, "--model_path",
                     str(tmp_path / "m.msgpack"), "--base_ch", str(BASE), "--batch_size", "2",
                     "--epochs", "1", "--preset", "eps_reference", "--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"best_loss", "epoch_loss", "skipped"} and len(last["epoch_loss"]) == 1
    with pytest.raises(SystemExit) as e:
        dispatch(["train", "--help"])
    assert e.value.code == 0


def test_cli_needs_a_card_unless_told_cpu(patches, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--patch_dir", patches, "--model_path", str(tmp_path / "m.msgpack"),
                  "--base_ch", str(BASE), "--epochs", "1"])


def test_bench_train_at_a_tiny_size():
    lines = []
    rows = bench_train.main(["2", "--device", "cpu", "--size", "32", "--base_ch", "8",
                             "--iters", "1"], emit=lines.append)
    assert [(r["B"], r["remat"]) for r in rows] == [(2, False), (2, True)]
    for r, ln in zip(rows, lines):
        assert json.loads(ln) == r and r["train_patches_per_s"] > 0 and r["skipped"] == 0
        assert r["bound_share"] is None and r["peak_mem_bytes"] is None and r["device"] == "cpu"
    assert rows[0]["loss"] == rows[1]["loss"]  # remat recomputes the same step
    # the reckoned bound: 2.9455e11 operations a 256² base-96 forward
    assert bench_train.conv_ops_per_sample(96, 256) == 294553387008.0
    assert bench_train.step_ops_per_sample(96, 256, True) == 4 * 294553387008.0
