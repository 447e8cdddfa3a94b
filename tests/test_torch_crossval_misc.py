"""The port against the reference's own eval scripts, second half: the
updated harness's six tables (``Evaluation_Updated/Evaluation.py``, with
``--full_metrics``) and the stdout scripts (``Limitation_Test`` ε and v,
with their saved prediction arrays, ``Onestep`` ε and v and
``Comparison_v``), 13 of the 27 committed tables, replayed on the CPU in
f32 by ``s1s2_torch.tools.ref_crossval`` (see ``test_torch_crossval.py``)."""

import pytest
import torch

from s1s2_torch.tools import ref_crossval as rc

FAMILIES = ("upd", "misc", "vmisc")
TABLES = [t[0] for run in rc.runs() if run[0] in FAMILIES for t in run[7]]


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("crossval")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the replay's small convs; the test run has a worker a core
    try:
        rc.run_replay(out, "cpu", "float32", FAMILIES)
    finally:
        torch.set_num_threads(threads)
    return rc.check(out, "float32", FAMILIES)


def test_the_families_hold_13_of_the_27_tables(report):
    assert len(TABLES) == report["tables_total"] == 13


@pytest.mark.parametrize("table", TABLES)
def test_table_matches_the_reference(report, table):
    entry = report["tables"][table]
    devs = {c: (v["max_dev"], v["tol"]) for c, v in entry["cols"].items()}
    print(table, devs)
    assert entry["pass"], (entry.get("error"), devs)

