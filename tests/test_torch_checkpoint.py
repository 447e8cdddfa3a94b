"""The port's pure-Python msgpack reader against msgpack and
flax.serialization, on synthetic blobs and on every committed checkpoint."""

import glob
import os

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import jax

from s1s2_torch.train import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(glob.glob(os.path.join(REPO, "examples", "checkpoints", "*.msgpack")))


def test_checkpoints_are_committed():
    assert len(CHECKPOINTS) >= 16


@pytest.mark.parametrize("path", CHECKPOINTS, ids=os.path.basename)
def test_reader_matches_flax_on_checkpoint(path):
    with open(path, "rb") as f:
        data = f.read()
    ref = serialization.msgpack_restore(data)
    got = ck.flatten(ck.msgpack_restore(data))
    ref_leaves = {tuple(k.key for k in p): v
                  for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    assert set(got) == set(ref_leaves)
    for key, r in ref_leaves.items():
        g = got[key]
        assert isinstance(g, torch.Tensor)
        assert str(g.dtype) == f"torch.{r.dtype}", key
        assert tuple(g.shape) == r.shape, key
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -2.25e-300, "", "a" * 31, "é" * 40, "x" * 300, "y" * 70000,
    b"", b"\x00\xff" * 200, b"z" * 70000,
    [], list(range(20)), {"k": [1, {"n": None}]}, {str(i): i for i in range(20)},
    list(range(70000)),
])
def test_reader_matches_msgpack(obj):
    data = msgpack.packb(obj, use_bin_type=True)
    assert ck.unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)


def test_reader_float32():
    data = msgpack.packb(1.25, use_single_float=True)
    assert data[0] == 0xCA and ck.unpackb(data) == 1.25


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 3, 200, 70000])
def test_reader_ext_lengths(n):
    """fixext 1..16, ext 8/16 — decoded through flax's ext codes."""
    arr = np.arange(n, dtype=np.uint8)
    inner = msgpack.packb(((n,), "uint8", arr.tobytes()), use_bin_type=True)
    data = msgpack.packb(msgpack.ExtType(1, inner))
    got = ck.unpackb(data)
    np.testing.assert_array_equal(got.numpy(), arr)


@pytest.mark.parametrize("dtype", ["float32", "float16", "float64", "int8", "int16",
                                   "int32", "int64", "uint8", "bool"])
def test_flax_arrays_and_scalars(dtype):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((3, 5)) * 10).astype(dtype)
    tree = {"a": a, "s": a.reshape(-1)[1], "e": np.zeros((0, 4), dtype),
            "nested": {"b": a[:1]}}
    got = ck.msgpack_restore(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"].numpy(), a)
    assert got["s"] == a.reshape(-1)[1].item()
    assert tuple(got["e"].shape) == (0, 4)
    np.testing.assert_array_equal(got["nested"]["b"].numpy(), a[:1])


def test_bfloat16_array_roundtrip():
    x = jax.numpy.arange(-8, 8, dtype=jax.numpy.float32).reshape(4, 4) / 3
    tree = {"w": np.asarray(x.astype(jax.numpy.bfloat16))}
    got = ck.msgpack_restore(serialization.msgpack_serialize(tree))["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(tree["w"], np.float32))


def test_chunked_arrays_refused(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    a = np.arange(100, dtype=np.float32).reshape(10, 10)
    with pytest.raises(ValueError, match="chunked"):
        ck.msgpack_restore(serialization.msgpack_serialize({"big": a}))


@pytest.mark.parametrize("tree", [{"c": 1.0 + 2.0j}, {"x": msgpack.ExtType(7, b"ab")}])
def test_other_ext_codes_refused(tree):
    data = (serialization.msgpack_serialize(tree) if "c" in tree
            else msgpack.packb(tree))
    with pytest.raises(ValueError, match="ext code"):
        ck.msgpack_restore(data)


def test_truncated_and_trailing_data_raise():
    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        ck.unpackb(data[:-1])
    with pytest.raises(ValueError):
        ck.unpackb(data + b"\x00")


def test_load_params_24x4():
    tree = ck.load_params(os.path.join(REPO, "examples", "checkpoints",
                                       "distill_eps_student24x4.bf16.msgpack"))
    flat = ck.flatten(tree)
    assert len(flat) == 34
    assert all(v.dtype == torch.bfloat16 for v in flat.values())
    assert tuple(tree["inc"]["kernel"].shape) == (3, 3, 129, 24)


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -2.25e-300, "", "a" * 31, "é" * 40, "x" * 300, "y" * 70000,
    b"", b"\x00\xff" * 200, b"z" * 70000,
    [], list(range(20)), {"k": [1, {"n": None}]}, {str(i): i for i in range(20)},
    list(range(70000)), {str(i): [i] for i in range(70000)},
])
def test_writer_matches_msgpack(obj):
    assert ck.packb(obj) == msgpack.packb(obj, use_bin_type=True)


def test_writer_matches_flax_on_a_quant_like_tree():
    """flax's bytes for the same tree, keys sorted as flax sorts them:
    float32, int8, bfloat16 (torch) and 0-d arrays, empty arrays, ext 8/16/32
    lengths, numpy scalars."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    bf = np.asarray(rng.standard_normal((3, 5)), ml_dtypes.bfloat16)
    tree = {"w8": {"down1/conv1": {"q": rng.integers(-127, 128, (3, 3, 4, 5)).astype(np.int8),
                                   "s": rng.random(5).astype(np.float32)}},
            "act_scale": {"up3": np.asarray(0.25, np.float32), "b": rng.random(7).astype(np.float32)},
            "meta": {"out_ch": np.int32(4), "act_perchannel": np.int32(1)},
            "z": {"e": np.zeros((0, 3), np.float32), "big": np.ones(20000, np.float32),
                  "one": np.ones(1, np.int8), "two": np.ones(2, np.int8)},
            "bf": bf, "py": 1.5, "n": 3}
    ref = serialization.msgpack_serialize(tree)
    port = dict(tree, bf=torch.from_numpy(bf.view(np.uint16).copy()).view(torch.bfloat16))
    port["w8"] = {"down1/conv1": {k: torch.from_numpy(v) for k, v in
                                  tree["w8"]["down1/conv1"].items()}}
    assert ck.msgpack_serialize(port) == ref
    assert ck.msgpack_serialize(tree) == ref
    back = ck.msgpack_restore(ref)
    assert back["meta"] == {"act_perchannel": 1, "out_ch": 4}
    assert back["act_scale"]["up3"].dim() == 0 and float(back["act_scale"]["up3"]) == 0.25


def test_writer_round_trips_a_checkpoint():
    """A committed checkpoint read by the port and written back gives flax's
    bytes of the same tree."""
    path = os.path.join(REPO, "examples", "checkpoints", "distill_eps_student24x4.bf16.msgpack")
    with open(path, "rb") as f:
        data = f.read()
    assert ck.msgpack_serialize(ck.msgpack_restore(data)) == \
        serialization.msgpack_serialize(serialization.msgpack_restore(data))


@pytest.mark.parametrize("bad", [{"c": 1.0 + 2.0j}, {"s": {1, 2}}, {"u": np.zeros(2, np.uint32)}])
def test_writer_refuses_what_it_cannot_write(bad):
    with pytest.raises((TypeError, ValueError)):
        ck.msgpack_serialize(bad)
