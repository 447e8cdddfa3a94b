"""The port against the reference's own eval scripts: ``s1s2_torch.tools.
ref_crossval`` replays, on the CPU in f32, the runs behind the committed
``examples/ref_crossval/ref_eval_*`` tables (the reference's ``.pth``
checkpoints through the port's reader, the reference scripts' torch noise
streams through ``--noise_npz``) and each table must pass within the
crossval tool's own per-column tolerances. This file holds the ε, v,
pure-generation and sweep families (14 tables);
``test_torch_crossval_misc.py`` the updated-harness and stdout families
(13 tables)."""

import pytest
import torch

from s1s2_torch.tools import ref_crossval as rc

FAMILIES = ("eps", "v", "pure", "sweep")
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


def test_the_families_hold_14_of_the_27_tables(report):
    assert len(TABLES) == report["tables_total"] == 14


@pytest.mark.parametrize("table", TABLES)
def test_table_matches_the_reference(report, table):
    entry = report["tables"][table]
    devs = {c: (v["max_dev"], v["tol"]) for c, v in entry["cols"].items()}
    print(table, devs)
    assert entry["pass"], (entry.get("error"), devs)


def test_ddim_mae_within_the_csv_quantum(report):
    """The ε ddim table's MAE column agrees to the CSV's rounding quantum,
    as the JAX harness's does."""
    assert report["tables"]["eps/ddim/ddim_metrics.csv"]["cols"]["MAE"]["max_dev"] <= 2e-6
