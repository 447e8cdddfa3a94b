"""One rank of a Gloo cluster on the CPU for tests/test_torch_mesh_cluster.py.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_mesh_worker.py OUT_DIR SCENARIO [SCENARIO ...]

torchrun's environment brings the group up (``initialize_distributed``).
Each scenario builds its mesh over the world, runs one train step of the
port (and, for the data × model meshes, one ``ddim_anchored`` call) on inputs
made from a seed with numpy, and writes ``OUT_DIR/<scenario>_r<rank>.npz``:
the loss, the full parameters after the step (gathered over the model axis),
this rank's ``inc`` kernel shape and the gathered sample. The single-process
references are computed by the test; :func:`setup` is shared with it. Ranks
a mesh leaves idle write nothing for it.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from s1s2_torch.core import random  # noqa: E402
from s1s2_torch.core.schedule import Schedule  # noqa: E402
from s1s2_torch.models.unet import UNetSmall, init_params, load_unet  # noqa: E402
from s1s2_torch.train import loop  # noqa: E402

# scenario → (mesh (data, space, model), base, H, B, T, config, devices)
SCENARIOS = {
    "dp4": ((4, 1, 1), 4, 16, 8, 20, dict(t_sampler="uniform", lr=1e-3), None),
    "dp2": ((2, 1, 1), 4, 16, 8, 20, dict(mask_as_weights=True, cfg_drop_prob=0.5),
            (0, 1)),
    "ds": ((2, 2, 1), 4, 32, 4, 20, dict(t_sampler="uniform", lr=1e-3), None),
    "dm": ((2, 1, 2), 8, 16, 4, 10, dict(pred_param="v", t_sampler="mix_high"), None),
    "m4": ((1, 1, 4), 8, 16, 4, 10, dict(pred_param="v", t_sampler="mix_high"), None),
    # space × model with recomputed blocks: the halo and the gather run again
    # in the backward
    "sm": ((1, 2, 2), 4, 32, 2, 20, dict(t_sampler="uniform", lr=1e-3), None),
    # a NaN in data rank 0's rows only: every rank skips the step
    "nan": ((2, 1, 1), 4, 16, 4, 20, dict(t_sampler="uniform", lr=1e-3), (0, 1)),
}
REMAT = {"sm"}
KEY = random.PRNGKey(7)
SAMPLE = dict(t_start=8, steps=3)


def setup(name):
    """(params, cfg, schedule, batch, sample noise) of a scenario."""
    _, base, H, B, T, kw, _ = SCENARIOS[name]
    rng = np.random.default_rng(5)
    batch = (rng.standard_normal((B, H, H, 4)).astype(np.float32),
             rng.uniform(0, 1, (B, H, H, 4)).astype(np.float32),
             (rng.uniform(0, 1, (B, H, H)) > 0.3).astype(np.float32))
    noise = rng.standard_normal((B, H, H, 4)).astype(np.float32)
    if name == "nan":
        batch[0][0, 3, 4, 1] = np.nan
    return (init_params(4, base, 1, seed=0, in_ch=8), loop.TrainConfig(T=T, **kw),
            Schedule.cosine(T), batch, noise)


def run(name, out_dir):
    from s1s2_torch.parallel.mesh import make_mesh, shard_train_step
    from s1s2_torch.sampling.samplers import ddim_anchored, make_denoise_fn
    from s1s2_torch.train.loop import tp_gather_state

    (data, space, model), base, *_, devices = SCENARIOS[name]
    mesh = make_mesh(data, space, model, devices=devices)
    if not mesh.active:
        return
    params, cfg, schedule, batch, noise = setup(name)
    net = UNetSmall(4, base, 1, 8, torch.float32, autograd=True, remat=name in REMAT,
                    mesh=mesh)
    state = loop.create_train_state(params, cfg)
    step = shard_train_step(loop.make_train_step(net, schedule, cfg, draws="threefry",
                                                 mesh=mesh),
                            mesh, spatial=space > 1, state_template=state)
    rows = mesh.rows(batch[0].shape[0])
    state, m = step(state, tuple(a[rows] for a in batch), KEY)
    inc_shape = state.layout.shapes[state.layout.names.index("inc.kernel")]
    full = tp_gather_state(state, mesh)
    out = dict(loss=float(m["loss"]), ch=m["ch_losses"].numpy(), skipped=int(m["skipped"]),
               params=full.params.numpy(), ema=full.ema_params.numpy(),
               inc_shape=np.asarray(inc_shape))
    if model > 1 and space == 1:  # the inference path shards over data and model
        infer = load_unet(params, 4, base, 1, 8, torch.float32, device="cpu", mesh=mesh)
        cond, gt = (torch.from_numpy(a[rows]) for a in batch[:2])
        x0 = ddim_anchored(make_denoise_fn(infer, cond), gt, schedule,
                           noise=torch.from_numpy(noise[rows]), **SAMPLE)
        out["sample"] = mesh.all_gather(x0, ("data",)).numpy()
    np.savez(os.path.join(out_dir, f"{name}_r{mesh.rank}.npz"), **out)


def main():
    from s1s2_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    out_dir, names = sys.argv[1], sys.argv[2:]
    initialize_distributed(backend="gloo")
    for name in names:
        run(name, out_dir)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
