"""BENCHMARK.json against the benchmark's contract, and every name in it
found on disk."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MANIFEST["paths"]), w
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS + [m["name"] for m in METRICS]
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for n in names:
        assert NAME.match(n), n
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and one_line(w["why"])
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["unit"] == "%" and (m["name"].endswith("_roofline") or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in MANIFEST["per_layer"])
        for m in MANIFEST["per_layer"]:
            if cell in m.get("workloads", CELLS):
                assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    cfg = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert cfg["file"].startswith("benchmark/")
    conf = json.loads((ROOT / cfg["file"]).read_text())
    assert conf["name"] == cfg["name"] and conf["reduced"] == cfg["reduced"]
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    assert mix["denoiser"] in conf["precision"]
    from benchmark.harness.traffic import plugin

    entry, den = plugin("entries", mix["entry"]), plugin("denoisers", mix["denoiser"])
    assert entry.forwards(mix) >= 1 and callable(entry.program) and callable(entry.reference)
    assert set(den.MODES) == {"inc", "blocks", "up", "head"} and callable(den.program)
    chk = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
    from benchmark.harness.check import NUMBERS

    assert chk["limits"] and set(chk["limits"]) <= set(NUMBERS)
    ctl = chk["control"]
    assert len(ctl) == 1 and set(ctl) <= {"mix", "reference"}
    if "reference" in ctl:
        assert callable(plugin("denoisers", ctl["reference"]).reference)
    else:
        assert callable(plugin("denoisers", ctl["mix"].get("denoiser", mix["denoiser"])).program)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_its_reader(metric):
    text = (ROOT / "benchmark" / "metrics" / f"{metric}.py").read_text()
    assert "def read(ctx)" in text


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
