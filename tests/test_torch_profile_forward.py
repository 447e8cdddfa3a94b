"""``s1s2_torch/tools/profile_forward.py`` at a tiny size on the CPU: it
traces one DDIM call through ``trace_headline.profile`` (host only on the
CPU) and writes a Chrome trace that parses, with the call's operators in
it."""

import json

import torch

from s1s2_torch.tools import profile_forward

torch.set_num_threads(1)


def test_writes_a_trace_that_parses(tmp_path):
    lines = []
    r = profile_forward.run(str(tmp_path / "tr"), batch=2, base=8, size=16, steps=2,
                            device="cpu", emit=lines.append)
    assert r["trace"] == str(tmp_path / "tr" / "trace.json")
    with open(r["trace"]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert "aten::convolution" in names  # the conv's plain version on the CPU
    assert r["device"] == "cpu" and r["idle_share"] is None and r["wall_ms"] > 0
    assert r["kernels"] and r["kernels"][0]["ms"] >= r["kernels"][-1]["ms"]
    assert lines[-2] == f"trace written to {r['trace']}"
    assert json.loads(lines[-1])["trace"] == r["trace"]


def test_main_defaults_to_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(profile_forward.tempfile, "tempdir", str(tmp_path))
    seen = {}
    monkeypatch.setattr(profile_forward, "run", lambda out, **kw: seen.setdefault("out", out))
    profile_forward.main(["--device", "cpu"])
    assert seen["out"] == str(tmp_path / "s1s2_trace")
