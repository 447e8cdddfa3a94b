"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface and includes no PyTorch
header, so the build needs only ``nvcc`` and takes seconds. At first use:

* ``nvcc`` is found through ``CUDA_HOME``, then ``/usr/local/cuda/bin``,
  then ``PATH``;
* each source is compiled for ``sm_90a`` by its own ``nvcc`` process, all
  started together, and the objects are linked into one shared library
  under ``s1s2_torch/_build/<hash of sources and flags>/libs1s2k.so``;
* every ``nvcc`` call has a time limit; the library is written under a
  temporary name and moved into place with ``os.replace``, so two processes
  never see a half-written file and no lock file exists;
* ``ptxas`` reports each kernel's registers, shared memory and spills
  (``-Xptxas -v``); the lines are kept beside the library and printed once
  per process.

There is no fallback: a missing ``nvcc``, a failed build or a failed load
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libs1s2k.so"
COMPILE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-shared"]
BUILD_TIMEOUT_S = 240.0


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the s1s2_torch kernels need the CUDA toolkit to build")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of this process's build, 0.0 if it was on disk
    compiled: bool
    ptxas: List[str]  # the "ptxas info" lines of -Xptxas -v


def _sources() -> List[Path]:
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    return sources


def _build_dir(sources: List[Path]) -> Path:
    h = hashlib.sha256()
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _ptxas_lines(stderr: str) -> List[str]:
    """Each kernel's entry, properties (stack frame and spills) and usage
    lines, and ptxas's advisories (such as a wgmma pipeline it serialized)."""
    keep = ("Used", "Compiling entry", "Function properties", "(C7")
    return [ln.strip() for ln in stderr.splitlines()
            if ("ptxas" in ln and any(k in ln for k in keep)) or "spill stores" in ln]


def _run_all(cmds: List[List[str]], deadline: float) -> List[str]:
    """Run the commands together; raise if any fails or outlives the deadline.
    Returns their stderr texts."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = []
    try:
        for cmd, p in zip(cmds, procs):
            try:
                out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"nvcc took longer than {BUILD_TIMEOUT_S:.0f} s: {' '.join(cmd)}")
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{out}\n{err}")
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return errs


def build() -> BuildInfo:
    """Build the library if this checkout has not built it yet."""
    sources = _sources()
    out_dir = _build_dir(sources)
    lib, log = out_dir / LIB_NAME, out_dir / "ptxas.txt"
    if lib.is_file():
        ptxas = log.read_text().splitlines() if log.is_file() else []
        return BuildInfo(lib, 0.0, False, ptxas)
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{time.monotonic_ns()}"
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in sources]
    tmp_lib = out_dir / f"{LIB_NAME}.{tag}.tmp"
    tmp_log = out_dir / f"ptxas.{tag}.tmp"
    t0 = time.monotonic()
    deadline = t0 + BUILD_TIMEOUT_S
    try:
        errs = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(s), "-o", str(o)]
                         for s, o in zip(sources, objs)], deadline)
        _run_all([[nvcc, *LINK_FLAGS, *map(str, objs), "-o", str(tmp_lib)]], deadline)
        ptxas = [ln for e in errs for ln in _ptxas_lines(e)]
        tmp_log.write_text("\n".join(ptxas) + "\n")
        os.replace(tmp_log, log)
        os.replace(tmp_lib, lib)
    finally:
        for p in (*objs, tmp_lib, tmp_log):
            p.unlink(missing_ok=True)
    return BuildInfo(lib, time.monotonic() - t0, True, ptxas)


class Kernels:
    """The loaded library, with ctypes signatures for every entry point:
    pointers and the stream are ``c_void_p``, sizes ``c_int``/``c_int64``,
    scalars ``c_float``. Each returns a ``cudaError_t`` as an int."""

    def __init__(self, info: BuildInfo):
        self.info = info
        self.lib = ctypes.CDLL(str(info.path))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        sigs = {
            # x, w, bias, y, B, H, W, Cin, Cout, relu, device, stream
            "s1s2k_conv3x3_bf16": [P, P, P, P, I, I, I, I, I, I, I, P],
            # x, x8 scratch, packed w8, deq, bias, y, B, H, W, Cin, Cout, sx, relu,
            # device, stream
            "s1s2k_conv3x3_int8": [P, P, P, P, P, P, I, I, I, I, I, F, P, I, I, P],
            # x8, packed w8, deq, bias, y8, B, H, W, Cin, Cout, relu, device, stream
            "s1s2k_conv3x3_int8_q": [P, P, P, P, P, I, I, I, I, I, I, I, P],
            # mode (1: int8), Cs, Cout, out: int[6]
            "s1s2k_conv3x3_plan": [I, I, I, P],
            # x, eps, x0, xn, n, s1m, sabg, sabn, s1mn, device, stream
            "s1s2k_ddim_update": [P, P, P, P, ctypes.c_int64, F, F, F, F, I, P],
            # a, b, b_t scratch (int8), c, M, N, K, mode, device, stream
            "s1s2k_matmul": [P, P, P, P, I, I, I, I, I, P],
            # x, y, H, W, C, TH, device, stream
            "s1s2k_halo_rows_x2": [P, P, I, I, I, I, I, P],
        }
        for name, argtypes in sigs.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = I
            setattr(self, name, fn)


@functools.lru_cache(maxsize=None)
def kernels() -> Kernels:
    """Build (at first use) and load the kernels; prints the ptxas lines
    once per process."""
    info = build()
    for line in info.ptxas:
        print(line, flush=True)
    return Kernels(info)


def stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    ``torch.device``), for a launch. It skips the ``torch.cuda.Stream``
    object that ``torch.cuda.current_stream(device).cuda_stream`` builds on
    every call, which takes about as much host time as the launch itself:
    for a kernel as short as the probe's halo load, the host sets the
    pace."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
