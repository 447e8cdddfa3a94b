"""One rank of a Gloo cluster on the CPU for tests/test_torch_mesh_cli.py.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_mesh_cli_worker.py SPEC.json OUT_DIR

SPEC.json is a list of ``[name, argv]``: each argv runs through
``python -m s1s2_torch``'s dispatcher in this process, in order, with
``{rank}`` in it replaced by the rank, and its output goes to
``OUT_DIR/<name>_r<rank>.log``; an exception is written there as
``ERROR <type>: <message>`` and the next run goes on. The first CLI that
needs the process group brings it up from torchrun's environment; the
others find it up.
"""

import contextlib
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch

    from s1s2_torch.__main__ import main as dispatch

    torch.set_num_threads(1)
    spec_path, out_dir = sys.argv[1:3]
    rank = os.environ["RANK"]
    with open(spec_path) as f:
        spec = json.load(f)
    for name, argv in spec:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                dispatch([a.replace("{rank}", rank) for a in argv])
        except Exception as e:  # recorded for the test, which expects some
            buf.write(f"ERROR {type(e).__name__}: {e}\n")
        with open(os.path.join(out_dir, f"{name}_r{rank}.log"), "w") as f:
            f.write(buf.getvalue())
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
