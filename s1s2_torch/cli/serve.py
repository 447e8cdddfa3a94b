"""Inference server: S1 conditioning in, S2 prediction out. The port of the
JAX package's ``cli/serve.py``, with its flags, protocol and batching, and
``--device``.

    python -m s1s2_torch serve --int8_ckpt student.int8.msgpack --port 8080 \\
        [--t_start 999 --steps 1 --pred_param v]

It serves pure generation, the sampler stack of ``infer_scene``: unit noise
per request seed, then DDIM on the round-unique grid (η = 0) or
DPM-Solver++(2M), through the bf16 net or the int8 artifact written by
``python -m s1s2_torch quantize`` (or the JAX package's). The predictor runs
on one fixed (batch, patch) signature, warmed up once at startup (on a card
that includes building the kernels); a request of any batch size is cut into
chunks of that batch, the last padded with copies of its last row.

The noise of the chunk at offset s is drawn from ``(seed + s) & 0x7FFFFFFF``:
on the CPU as the JAX package draws it, ``normal(PRNGKey(that), (B,ps,ps,C))``
with its own bits (``core/random.py``); on a card from a CUDA
``torch.Generator`` seeded with it, which is deterministic per (seed, chunk)
too, but other bits (drawing jax's bits on the host would cost over a second
a chunk).

Requests are served by ``ThreadingHTTPServer`` threads. The lock covers only
the enqueue of a chunk's work on the card's stream: the upload from pinned
memory, the forward and the download into a pinned buffer, all
non-blocking; the download then runs, and is waited for through an event,
outside the lock. So request B's upload and compute queue up behind request
A's while A's results drain.

Protocol (stdlib HTTP):

* ``GET /healthz`` → JSON: the model, the signature, the startup warm-up
  (build and first call apart) and the count of requests served.
* ``POST /infer`` → body an ``.npz`` with key ``cond`` shaped (B,H,W,Cc),
  (H,W,Cc) or channels-first (B,Cc,H,W); optional scalar ``seed``. The
  response is ``.npy`` bytes, (B,H,W,out_ch) float32; a malformed request
  gets 400.
"""

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("s1s2_torch serve")
    ap.add_argument("--ckpt", default=None, help="bf16 checkpoint (.msgpack/.pth)")
    ap.add_argument("--int8_ckpt", default=None,
                    help="prequantized artifact from `quantize` (topology self-described; "
                         "overrides --ckpt)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 = ephemeral (actual port printed on startup)")
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--base_ch", type=int, default=96)
    ap.add_argument("--s2d", type=int, default=1)
    ap.add_argument("--cond_ch", type=int, default=4)
    ap.add_argument("--out_ch", type=int, default=4)
    ap.add_argument("--pred_param", choices=["eps", "v"], default="v")
    ap.add_argument("--t_start", type=int, default=999)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--solver", choices=["ddim", "dpm2m"], default="ddim")
    ap.add_argument("--guidance_scale", type=float, default=None)
    ap.add_argument("--patch_size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=16,
                    help="the predictor's fixed batch; requests are chunked and padded to it")
    ap.add_argument("--transfer_dtype", choices=["float16", "float32"], default="float16",
                    help="host<->device dtype of cond and predictions")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap


def _torch_dtype(name: str):
    import torch

    return {"float16": torch.float16, "float32": torch.float32}[name]


def make_predictor(args, device):
    """``predict(cond (B,ps,ps,Cc) tensor on device, seed int) → (B,ps,ps,
    out_ch)`` in the transfer dtype on ``device``: pure generation from unit
    noise drawn for ``seed``. With ``--int8_ckpt`` the artifact's topology
    replaces base_ch, s2d and out_ch in ``args``."""
    import torch

    from s1s2_torch.core import random
    from s1s2_torch.core.parametrize import Parameterization
    from s1s2_torch.core.schedule import Schedule
    from s1s2_torch.models.quant import (load_quant, make_quant_cfg_denoise_fn,
                                         make_quant_denoise_fn)
    from s1s2_torch.models.unet import load_unet
    from s1s2_torch.models.weights import params_from_numpy
    from s1s2_torch.sampling.dpm_solver import dpm_solver_2m
    from s1s2_torch.sampling.grids import round_unique_grid
    from s1s2_torch.sampling.samplers import (ddim_grid_sample, make_cfg_denoise_fn,
                                              make_denoise_fn)
    from s1s2_torch.train.checkpoint import load_params

    schedule = Schedule.cosine(args.T)
    param = Parameterization(args.pred_param)
    grid = round_unique_grid(args.t_start, args.steps, args.T)
    ab = float(schedule.alpha_bar_np()[min(max(args.t_start, 1), args.T - 1)])
    vscale = float(np.sqrt(1.0 - ab))
    qp = model = None
    if args.int8_ckpt:
        qp = load_quant(args.int8_ckpt, device)
        args.base_ch, args.s2d, args.out_ch = qp.base_ch, qp.stem_s2d, qp.out_ch
    else:
        state = {k: v.to(device) for k, v in params_from_numpy(load_params(args.ckpt)).items()}
        model = load_unet(state, args.out_ch, args.base_ch, args.s2d,
                          in_ch=args.cond_ch + args.out_ch, device=device)
    ps, C, wire = args.patch_size, args.out_ch, _torch_dtype(args.transfer_dtype)

    def noise(B, seed):
        shape = (B, ps, ps, C)
        if device.type == "cpu":
            return torch.from_numpy(random.normal(random.PRNGKey(seed), shape))
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    def predict(cond_b, seed):
        cond_b = cond_b.float()
        z = noise(cond_b.shape[0], seed)
        if qp is not None:
            fn = (make_quant_cfg_denoise_fn(qp, cond_b, args.guidance_scale)
                  if args.guidance_scale is not None else make_quant_denoise_fn(qp, cond_b))
        elif args.guidance_scale is not None:
            fn = make_cfg_denoise_fn(model, cond_b, args.guidance_scale)
        else:
            fn = make_denoise_fn(model, cond_b)
        x0 = z if param is Parameterization.EPS else z * vscale
        if args.solver == "dpm2m":
            out = dpm_solver_2m(fn, x0, schedule, grid, param)
        else:
            out = ddim_grid_sample(fn, x0, schedule, grid, param, eta=0.0)
        # predictions leave the device in the transfer dtype
        return out.to(wire)

    return predict


class _State:
    """Server-wide model state; ``lock`` covers only the enqueue of a chunk's
    work, never the wait for its result."""

    def __init__(self, args):
        import torch

        from s1s2_torch.ops import _build

        self.args = args
        self.lock = threading.Lock()
        device = torch.device(args.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        t0 = time.perf_counter()
        if device.type == "cuda":
            _build.kernels()  # nvcc at first use, or the library already on disk
        self.build_s = round(time.perf_counter() - t0, 3)
        self.predict = make_predictor(args, device)
        self.requests = 0
        t1 = time.perf_counter()
        self.infer(np.zeros((args.batch_size, args.patch_size, args.patch_size, args.cond_ch),
                            np.float32), 0)
        self.first_call_s = round(time.perf_counter() - t1, 3)
        self.warmup_s = round(time.perf_counter() - t0, 3)
        self.requests = 0  # the warm-up is not a request

    def infer(self, cond: np.ndarray, seed: int) -> np.ndarray:
        """cond (B,ps,ps,Cc) float32 → (B,ps,ps,out_ch) float32; chunks and
        pads to the fixed batch. Every chunk is enqueued (under the lock)
        before any is collected, so chunk k+1's upload and compute queue
        behind chunk k's on the card while the host waits for k."""
        import torch

        a, dev = self.args, self.device
        wire = np.dtype(a.transfer_dtype)
        B, bs = cond.shape[0], a.batch_size
        cuda = dev.type == "cuda"
        pending = []
        for s in range(0, B, bs):
            chunk = cond[s:s + bs]
            n = chunk.shape[0]
            if n < bs:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - n, 0)], 0)
            host = torch.from_numpy(np.ascontiguousarray(chunk.astype(wire)))
            if cuda:  # pinned buffers, made outside the lock
                host = host.pin_memory()
                back = torch.empty((bs, a.patch_size, a.patch_size, a.out_ch),
                                   dtype=_torch_dtype(a.transfer_dtype), pin_memory=True)
            with self.lock, torch.no_grad():
                if cuda:
                    with torch.cuda.device(dev):
                        out = self.predict(host.to(dev, non_blocking=True),
                                           (seed + s) & 0x7FFFFFFF)
                        back.copy_(out, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record()
                else:
                    back, done = self.predict(host, (seed + s) & 0x7FFFFFFF), None
            pending.append((back, done, n))
        outs = []
        for back, done, n in pending:
            if done is not None:
                done.synchronize()
            outs.append(back.numpy().astype(np.float32)[:n])
        with self.lock:
            self.requests += 1
        return np.concatenate(outs, 0)


def make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            a = state.args
            self._json(200, {
                "status": "ok",
                "model": {"base_ch": a.base_ch, "s2d": a.s2d, "out_ch": a.out_ch,
                          "cond_ch": a.cond_ch, "int8": bool(a.int8_ckpt),
                          "pred_param": a.pred_param, "solver": a.solver,
                          "t_start": a.t_start, "steps": a.steps,
                          "guidance_scale": a.guidance_scale},
                "signature": {"batch": a.batch_size, "patch": a.patch_size,
                              "transfer_dtype": a.transfer_dtype},
                "device": str(state.device),
                "warmup_s": state.warmup_s,
                "warmup_parts": {"build_s": state.build_s, "first_call_s": state.first_call_s},
                "requests": state.requests,
            })

        def do_POST(self):
            if self.path != "/infer":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                blob = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                cond = np.asarray(blob["cond"], np.float32)
                seed = int(blob["seed"]) if "seed" in blob else 0
                if cond.ndim == 3:
                    cond = cond[None]
                if cond.ndim != 4:
                    raise ValueError(f"cond must be 3-D or 4-D, got {cond.ndim}-D")
                if (cond.shape[-1] != state.args.cond_ch
                        and cond.shape[1] == state.args.cond_ch):
                    cond = np.transpose(cond, (0, 2, 3, 1))  # NCHW → NHWC
                ps = state.args.patch_size
                if cond.shape[1:] != (ps, ps, state.args.cond_ch):
                    raise ValueError(f"cond shape {cond.shape[1:]} != the served signature "
                                     f"({ps},{ps},{state.args.cond_ch})")
            except Exception as e:  # malformed request
                return self._json(400, {"error": str(e)})
            out = state.infer(cond, seed)
            buf = io.BytesIO()
            np.save(buf, out)
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def build_server(args) -> ThreadingHTTPServer:
    """Construct and warm up the server without entering serve_forever (for
    tests and embedding); the state is ``server.s1s2_state``."""
    if not args.ckpt and not args.int8_ckpt:
        raise SystemExit("serve: one of --ckpt / --int8_ckpt is required")
    state = _State(args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(state))
    httpd.s1s2_state = state
    return httpd


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    httpd = build_server(args)
    state = httpd.s1s2_state
    print(json.dumps({
        "serving": f"http://{httpd.server_address[0]}:{httpd.server_address[1]}",
        "device": str(state.device), "warmup_s": state.warmup_s,
        "warmup_parts": {"build_s": state.build_s, "first_call_s": state.first_call_s},
        "signature": [args.batch_size, args.patch_size, args.patch_size, args.cond_ch],
        "int8": bool(args.int8_ckpt),
    }), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
