"""Serving benchmark: latency and throughput of ``s1s2_torch serve``.

    python -m s1s2_torch quantize \\
        --ckpt examples/checkpoints/distill_cfg_puregen_student24.bf16.msgpack \\
        --base_ch 24 --patch_dir P --t_start 999 --out /tmp/w24.int8.msgpack
    python -m s1s2_torch.tools.bench_serve --int8_ckpt /tmp/w24.int8.msgpack

The port of the JAX package's ``tools/bench_serve.py``. The HTTP server of
``cli/serve.py`` runs in this process; clients drive it over loopback HTTP
with npz bodies, so every number includes HTTP parsing, npz
(de)serialization, the host-device copies and the sampler. Phases:

1. a server with batch 1: single-request latency p50/p95;
2. a server with batch ``--batch``: that batch's latency p50/p95 and
   patches/s;
3. the same server with ``--threads`` concurrent clients for
   ``--sat_seconds``: saturated patches/s;
4. the served predictor alone on a batch already on the device, 50 calls
   with varying seeds: device-only patches/s.

Request seeds vary per call. Each row names the device.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request
from typing import Dict, List

import numpy as np


def post_infer(url: str, cond: np.ndarray, seed: int) -> np.ndarray:
    """POST /infer with an npz body {cond, seed} → the (B,ps,ps,out_ch) reply."""
    buf = io.BytesIO()
    np.savez(buf, cond=cond, seed=np.int64(seed))
    req = urllib.request.Request(url + "/infer", data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req) as resp:
        return np.load(io.BytesIO(resp.read()))


def latency_series(url: str, make_cond, n: int, b: int) -> Dict:
    lats = []
    for i in range(n):
        cond = make_cond(i)
        t0 = time.perf_counter()
        out = post_infer(url, cond, seed=1000 + i * b)
        lats.append(time.perf_counter() - t0)
        assert out.shape[0] == cond.shape[0]
    lats.sort()
    return {"p50_ms": 1e3 * lats[len(lats) // 2], "p95_ms": 1e3 * lats[int(len(lats) * 0.95)],
            "mean_ms": 1e3 * sum(lats) / len(lats), "n": n}


def start_server(serve_args: List[str]):
    """(server, url, state) of ``cli/serve.py`` serving on a thread."""
    from s1s2_torch.cli.serve import build_parser, build_server

    httpd = build_server(build_parser().parse_args(serve_args))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    host, port = httpd.server_address[:2]
    return httpd, f"http://{host}:{port}", httpd.s1s2_state


def stop_server(httpd) -> None:
    httpd.shutdown()
    httpd.server_close()


def main(argv=None, emit=print) -> List[Dict]:
    ap = argparse.ArgumentParser("s1s2_torch bench_serve")
    ap.add_argument("--int8_ckpt", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--pred_param", default="v")
    ap.add_argument("--t_start", type=int, default=999)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--base_ch", type=int, default=96,
                    help="only used with --ckpt (the int8 artifact describes itself)")
    ap.add_argument("--s2d", type=int, default=1)
    ap.add_argument("--batch", type=int, default=16, help="the throughput phases' batch")
    ap.add_argument("--n_lat", type=int, default=40)
    ap.add_argument("--sat_seconds", type=float, default=15.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--patch_size", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--out", default=None, help="append JSON rows here")
    args = ap.parse_args(argv)

    import torch

    from s1s2_torch.bench import device_name

    ckpt_args = (["--int8_ckpt", args.int8_ckpt] if args.int8_ckpt
                 else ["--ckpt", args.ckpt, "--base_ch", str(args.base_ch), "--s2d",
                       str(args.s2d)])
    common = ckpt_args + ["--port", "0", "--pred_param", args.pred_param, "--t_start",
                          str(args.t_start), "--steps", str(args.steps), "--patch_size",
                          str(args.patch_size), "--device", args.device]
    ps = args.patch_size
    rng = np.random.default_rng(7)
    conds = [rng.normal(size=(args.batch, ps, ps, 4)).astype(np.float32) for _ in range(4)]
    rows: List[Dict] = []

    def row(r):
        rows.append({**r, "device": device_name(state.device)})
        emit(json.dumps(rows[-1]))

    # 1: a batch-1 server, single-request latency
    httpd, url, state = start_server(common + ["--batch_size", "1"])
    try:
        post_infer(url, conds[0][:1], seed=1)  # connection warm-up
        lat1 = latency_series(url, lambda i: conds[i % 4][:1], args.n_lat, 1)
        row({"phase": "latency_b1", "warmup_s": state.warmup_s,
             "build_s": state.build_s, "first_call_s": state.first_call_s, **lat1,
             "patches_per_s": 1e3 / lat1["p50_ms"]})
    finally:
        stop_server(httpd)

    # 2: a server at the batch, its latency
    httpd, url, state = start_server(common + ["--batch_size", str(args.batch)])
    try:
        post_infer(url, conds[0], seed=2)
        latb = latency_series(url, lambda i: conds[i % 4], args.n_lat, args.batch)
        row({"phase": f"latency_b{args.batch}", "warmup_s": state.warmup_s,
             "build_s": state.build_s, "first_call_s": state.first_call_s, **latb,
             "patches_per_s": args.batch * 1e3 / latb["p50_ms"]})

        # 3: saturated, concurrent clients
        stop = time.perf_counter() + args.sat_seconds
        done = [0] * args.threads
        errors: List[BaseException] = []

        def worker(k):
            i = 0
            try:
                while time.perf_counter() < stop:
                    post_infer(url, conds[(k + i) % 4], seed=k * 100000 + i)
                    done[k] += args.batch
                    i += 1
            except BaseException as e:  # surfaced below
                errors.append(e)

        t0 = time.perf_counter()
        ths = [threading.Thread(target=worker, args=(k,)) for k in range(args.threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        dt = time.perf_counter() - t0
        if errors:
            raise errors[0]
        row({"phase": "saturated", "threads": args.threads, "batch": args.batch,
             "seconds": dt, "requests": sum(done) // args.batch,
             "patches_per_s": sum(done) / dt})

        # 4: the predictor alone, its input already on the device
        dev = state.device
        x = torch.from_numpy(conds[0].astype(np.dtype(state.args.transfer_dtype))).to(dev)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        n_iter = 50 if dev.type == "cuda" else 2
        with torch.no_grad():
            state.predict(x, 1)
            sync()
            t0 = time.perf_counter()
            for i in range(n_iter):  # seeds vary per call
                state.predict(x, 2 + i)
            sync()
        dt = time.perf_counter() - t0
        row({"phase": "device_only", "batch": args.batch,
             "patches_per_s": args.batch * n_iter / dt})
    finally:
        stop_server(httpd)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
