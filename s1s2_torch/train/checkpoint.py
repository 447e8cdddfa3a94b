"""Read and write the JAX package's msgpack checkpoints without msgpack,
flax or ml_dtypes.

The committed checkpoints are ``flax.serialization.msgpack_serialize`` blobs:
a msgpack map of maps whose leaves are msgpack *ext* values. Ext code 1 holds
an ndarray as a nested msgpack array ``[shape, dtype-name, raw C-order
bytes]``; ext code 3 a numpy scalar in the same form (the quantized
artifact's metadata). Other ext codes, and flax's chunked form of arrays
above 2^30 bytes, occur in no checkpoint of the repo and are refused.

This module decodes all of that in pure Python and returns torch tensors
(bfloat16 stays bfloat16, read with ``torch.frombuffer``), so weights load
on a machine that has torch and numpy and nothing of JAX. Its writer,
:func:`msgpack_serialize`, gives the bytes ``flax.serialization.
msgpack_serialize`` gives for the same tree: torch tensors and numpy arrays
as ext 1, numpy scalars as ext 3, nested dicts and lists, Python scalars
and strings in msgpack's smallest form.

The training artifacts of the JAX package's ``train/checkpoint.py``:
:func:`save_model` / :func:`load_model` write and read its model-only
files (the same bytes), with :func:`reference_artifact_paths` naming the
final/last/best triple. Its orbax resume state becomes the port's own
state file, :func:`save_state` / :func:`restore_state`: one msgpack blob
(params, Adam's moments and count, EMA, step, skip count) written by the
same writer, no pickles.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """A msgpack decoder over one bytes object: map, str, bin, array, int,
    float, nil, bool, ext 8/16/32 and fixext."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, n: int):
        code = self._unpack(">b")
        return _decode_ext(code, bytes(self._take(n)))

    def read(self) -> Any:
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self._take(n))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(n)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
            return self._unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self._take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of ``data``."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after msgpack object")
    return out


def _pack_len(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form when ``n <= fix_max``, else the first
    of ``codes`` ((byte, struct format) of the 8/16/32-bit forms) that holds
    ``n``."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n <= top:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"msgpack object of length {n} is too long")


_B8, _B16, _B32 = (0xFF, 0xFFFF, 0xFFFFFFFF)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, bool) and type(obj) is int:
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        elif obj > 0:
            for code, fmt, top in ((0xCC, "B", _B8), (0xCD, "H", _B16), (0xCE, "I", _B32),
                                   (0xCF, "Q", (1 << 64) - 1)):
                if obj <= top:
                    out.append(struct.pack(">B" + fmt, code, obj))
                    break
            else:
                raise ValueError(f"integer {obj} does not fit msgpack")
        else:
            for code, fmt, lo in ((0xD0, "b", -(1 << 7)), (0xD1, "h", -(1 << 15)),
                                  (0xD2, "i", -(1 << 31)), (0xD3, "q", -(1 << 63))):
                if obj >= lo:
                    out.append(struct.pack(">B" + fmt, code, obj))
                    break
            else:
                raise ValueError(f"integer {obj} does not fit msgpack")
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, ((0xD9, "B", _B8), (0xDA, "H", _B16),
                                            (0xDB, "I", _B32)))
        out.append(raw)
    elif type(obj) is bytes:
        _pack_len(out, len(obj), None, 0, ((0xC4, "B", _B8), (0xC5, "H", _B16),
                                           (0xC6, "I", _B32)))
        out.append(obj)
    elif type(obj) in (list, tuple):
        _pack_len(out, len(obj), 0x90, 15, ((0xDC, "H", _B16), (0xDD, "I", _B32)))
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(out, len(obj), 0x80, 15, ((0xDE, "H", _B16), (0xDF, "I", _B32)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _pack_ext(_EXT_NDARRAY, _array_parts(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_parts(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _array_parts(a) -> bytes:
    """An ndarray's ext payload: the msgpack array [shape, dtype name, raw
    C-order bytes]."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if name not in _DTYPES:
            raise ValueError(f"unsupported tensor dtype {t.dtype}")
        shape = tuple(t.shape)
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
    else:
        if a.dtype.hasobject or a.dtype.name not in _DTYPES:
            raise ValueError(f"unsupported array dtype {a.dtype}")
        name, shape, raw = a.dtype.name, a.shape, a.tobytes("C")
    return packb([list(shape), name, raw])


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fix is not None:
        out.append(struct.pack(">Bb", fix, code))
    else:
        _pack_len(out, n, None, 0, ((0xC7, "B", _B8), (0xC8, "H", _B16), (0xC9, "I", _B32)))
        out.append(struct.pack(">b", code))
    out.append(data)


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as msgpack, each value in its smallest form."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def msgpack_serialize(tree: Any) -> bytes:
    """flax's ``msgpack_serialize`` of a tree of dicts whose leaves are
    tensors, numpy arrays or scalars, Python scalars or strings: each dict's
    keys sorted (flax maps the tree through ``jax.tree_util`` first, which
    sorts them). Arrays above 2^30 bytes, which flax would split into
    chunks, are refused."""
    def canon(t):
        if isinstance(t, dict):
            return {k: canon(t[k]) for k in sorted(t)}
        if isinstance(t, torch.Tensor) and t.numel() * t.element_size() > 1 << 30 or (
                isinstance(t, np.ndarray) and t.nbytes > 1 << 30):
            raise ValueError("arrays above 2^30 bytes are not supported")
        return t
    return packb(canon(tree))


def _tensor_from_parts(shape, dtype_name, raw: bytes) -> torch.Tensor:
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name not in _DTYPES:
        raise ValueError(f"unsupported array dtype {dtype_name!r}")
    dtype = _DTYPES[dtype_name]
    shape = tuple(int(s) for s in shape)
    if len(raw) == 0:
        return torch.empty(shape, dtype=dtype)
    # bytearray: a writable private copy, so the tensor owns its memory
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def _decode_ext(code: int, data: bytes) -> Any:
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, raw = unpackb(data)
        t = _tensor_from_parts(shape, dtype_name, raw)
        return t if code == _EXT_NDARRAY else t.reshape(()).item()
    raise ValueError(f"unsupported msgpack ext code {code}")


def _refuse_chunked(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked (> 2^30 byte) arrays are not supported")
        for v in tree.values():
            _refuse_chunked(v)
    return tree


def msgpack_restore(data: bytes) -> Dict[str, Any]:
    """The state dict of a flax msgpack blob, leaves as CPU torch tensors."""
    return _refuse_chunked(unpackb(data))


def load_params(path: str) -> Dict[str, Any]:
    """Load a model-only msgpack checkpoint (the JAX package's
    ``save_model`` artifact) as a nested dict of CPU tensors, a reference
    ``.pth`` through ``models/convert.py`` as a nested dict of f32 arrays,
    or a state directory (:func:`save_state`) as its EMA params."""
    if path.endswith(".pth"):
        from s1s2_torch.models.convert import load_pth_checkpoint

        return load_pth_checkpoint(path)["params"]
    if os.path.isdir(path):
        return restore_state(path)["ema_params"]
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def nest(flat: Dict[str, Any]) -> Dict:
    """{"down1.conv1.kernel": t} → {"down1": {"conv1": {"kernel": t}}}."""
    tree: Dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _write(path: str, data: bytes) -> None:
    """Write ``data`` under a temporary name, then rename it into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_model(params: Dict[str, Any], path: str) -> None:
    """A model-only artifact: flax's msgpack bytes of the param tree (a flat
    state dict, nested by its dots, or a nested one), tensors read back to
    the host."""
    tree = nest(params) if all(not isinstance(v, dict) for v in params.values()) else params
    _write(path, msgpack_serialize(tree))


def load_model(template: Dict[str, torch.Tensor], path: str) -> Dict[str, torch.Tensor]:
    """A model-only artifact as a flat state dict with the names and shapes
    of ``template`` (a flat state dict, e.g. ``models.unet.init_params``);
    any other tree is refused as an architecture that does not match."""
    got = {".".join(k): v for k, v in flatten(load_params(path)).items()}
    want = {k: tuple(v.shape) for k, v in template.items()}
    have = {k: tuple(v.shape) for k, v in got.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:4]
        raise ValueError(
            f"checkpoint {path!r} does not match the model architecture "
            "(check --base_ch and the dataset's channel counts); "
            f"underlying error: names and shapes differ at {diff}")
    return {k: got[k] for k in template}


def reference_artifact_paths(model_path: str):
    """``x.msgpack`` → (final, last, best), the reference's ``.pth →
    _last/_best`` naming."""
    root, ext = os.path.splitext(model_path)
    return model_path, f"{root}_last{ext}", f"{root}_best{ext}"


STATE_FILE = "train_state.msgpack"


def state_file(path: str) -> str:
    """The state file inside a ``--save_state_dir``."""
    return os.path.join(path, STATE_FILE)


def save_state(state, path: str) -> None:
    """The resumable train state (``train/loop.TrainState``) into the
    directory ``path``, replacing what was there."""
    L = state.layout
    tree = {"step": int(state.step), "skipped": state.skipped,
            "params": nest(L.unflatten(state.params)),
            "opt_state": {"count": state.opt_state.count,
                          "mu": nest(L.unflatten(state.opt_state.mu)),
                          "nu": nest(L.unflatten(state.opt_state.nu))},
            "ema_params": nest(L.unflatten(state.ema_params))}
    _write(state_file(path), msgpack_serialize(tree))


def restore_state(path: str, template=None):
    """The state written by :func:`save_state`: its nested dict of CPU
    tensors, or, given a ``TrainState`` ``template``, a ``TrainState`` with
    the template's layout on the template's device."""
    with open(state_file(path), "rb") as f:
        tree = msgpack_restore(f.read())
    if template is None:
        return tree
    from s1s2_torch.train.loop import AdamState, TrainState

    L, device = template.layout, template.params.device

    def flat(t):
        leaves = {".".join(k): v for k, v in flatten(t).items()}
        if {k: tuple(v.shape) for k, v in leaves.items()} != dict(zip(L.names, L.shapes)):
            raise ValueError(f"state {path!r} does not match the model architecture")
        return L.flatten(leaves, device)

    opt = tree["opt_state"]
    return TrainState(step=int(tree["step"]), params=flat(tree["params"]),
                      opt_state=AdamState(opt["count"].to(device, torch.int32),
                                          flat(opt["mu"]), flat(opt["nu"])),
                      ema_params=flat(tree["ema_params"]),
                      skipped=tree["skipped"].to(device, torch.int32), layout=L)


def load_any_checkpoint(path: str, template: Optional[Dict[str, torch.Tensor]] = None):
    """``.pth`` → ``{"params": tree}`` through ``models/convert.py``; a file →
    :func:`load_model` (needs ``template``); a directory → the state
    file's nested dict (:func:`restore_state`)."""
    if path.endswith(".pth"):
        from s1s2_torch.models.convert import load_pth_checkpoint

        return load_pth_checkpoint(path)
    if os.path.isfile(path):
        if template is None:
            raise ValueError("msgpack load requires a params template")
        return load_model(template, path)
    return restore_state(path)


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """{("down1", "conv1", "kernel"): tensor, ...}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out
