"""``s1s2_torch/tools/demo_results_pack.sh`` against the JAX package's
``tools/demo_results_pack.sh``, as text: the same positional arguments,
``set -e`` and common flags, and every ``python -m s1s2.cli.evaluate`` call
with a twin ``python -m s1s2_torch.cli.evaluate`` call of identical flags,
in the same order; and each call's flags parse with the port's evaluate
parser."""

import os
import re
import shlex
from pathlib import Path

import pytest

from s1s2_torch.cli.evaluate import build_parser

REPO = Path(__file__).resolve().parents[1]
JAX_SH = REPO / "tools" / "demo_results_pack.sh"
PORT_SH = REPO / "s1s2_torch" / "tools" / "demo_results_pack.sh"


def _logical_lines(path):
    """The script's lines with backslash continuations joined, comments and
    blank lines dropped."""
    text = path.read_text().replace("\\\n", " ")
    return [ln.strip() for ln in text.splitlines()
            if ln.strip() and not ln.strip().startswith("#")]


def _calls(path, module):
    prefix = f"python -m {module} "
    return [ln[len(prefix):] for ln in _logical_lines(path) if ln.startswith(prefix)]


def test_same_calls_with_identical_flags():
    jax_calls = _calls(JAX_SH, "s1s2.cli.evaluate")
    port_calls = _calls(PORT_SH, "s1s2_torch.cli.evaluate")
    assert len(jax_calls) == len(port_calls) == 12
    assert [shlex.split(c) for c in port_calls] == [shlex.split(c) for c in jax_calls]
    assert port_calls[-1].endswith("--int8")


def test_same_arguments_setup_and_no_other_command():
    jax_lines, port_lines = _logical_lines(JAX_SH), _logical_lines(PORT_SH)
    setup = [ln for ln in jax_lines if not ln.startswith("python ")]
    assert [ln for ln in port_lines if not ln.startswith("python ")] == setup
    assert setup[0] == "set -e" and setup[1].startswith("P=$1; CKPT=$2; OUT=$3; PARAM=${4:-v}")
    assert not [ln for ln in port_lines if "s1s2.cli." in ln]  # the JAX package's CLI
    assert os.access(PORT_SH, os.X_OK) and PORT_SH.read_text().startswith("#!/bin/bash\n")


@pytest.mark.parametrize("i", range(12))
def test_each_call_parses_with_the_ports_parser(i):
    common = re.search(r'COMMON="([^"]*)"', PORT_SH.read_text()).group(1)
    call = _calls(PORT_SH, "s1s2_torch.cli.evaluate")[i].replace("$COMMON", common)
    values = {"$PARAM": "v", "$CKPT": "C.msgpack", "$OUT": "O", "$P": "P"}  # longest first
    for k, v in values.items():
        call = call.replace(k, v)
    args = build_parser().parse_args(shlex.split(call))
    assert args.patch_dir == "P" and args.out_dir.startswith("O/")
