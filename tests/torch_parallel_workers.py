"""Rank workers of the lvdgs_torch multi-device tests
(tests/test_torch_parallel_*.py).

Each function runs as one rank of a gloo world on the CPU, started by
lvdgs_torch.parallel.launch.spawn, and builds its mesh over every rank of
that world. The ranks do not load tests/conftest.py, and this module
imports neither JAX nor the reference package. Inputs and results are
NumPy arrays and plain values.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

PARAM_FIELDS = ("means", "features_dc", "log_scales", "quats", "logit_opacities")


def _np(x):
    return x.detach().cpu().numpy()


def sharded_step(rank, n_data, n_gauss, scene, batch, intr, rcfg):
    """One make_sharded_mapping_step step on an (n_data, n_gauss) mesh from
    zero Adam moments: this rank's rows of the new map and moments."""
    from lvdgs_torch.parallel import make_mesh, make_sharded_mapping_step

    mesh = make_mesh(n_data, n_gauss, device="cpu")
    params = {f: torch.tensor(scene[f]) for f in PARAM_FIELDS}
    zeros = {f: torch.zeros_like(params[f]) for f in PARAM_FIELDS}
    step, shard_fn = make_sharded_mapping_step(mesh, intr, rcfg)
    p, a, m, v, cb = shard_fn(params, torch.tensor(scene["active"]), zeros, zeros,
                              {k: torch.tensor(x) for k, x in batch.items()})
    new_p, new_m, new_v, count, loss = step(p, a, m, v, 0, cb["images"], cb["mono_depths"], cb["Rs"],
                                            cb["Ts"], cb["taus"])
    return {"data": mesh.get_local_rank("data"), "gauss": mesh.get_local_rank("gauss"), "count": count,
            "loss": float(loss), "params": {f: _np(x) for f, x in new_p.items()},
            "m": {f: _np(x) for f, x in new_m.items()}, "v": {f: _np(x) for f, x in new_v.items()}}


def camera_dp_mapping(rank, gmap, kfbuf, window, iteration_count, n_iters, intr, rcfg, opt, mcfg, seed):
    """mapping_run with a mesh over every rank from a fresh Adam state."""
    from lvdgs_torch import convert
    from lvdgs_torch.parallel import make_mesh
    from lvdgs_torch.slam.mapping import mapping_run

    mesh = make_mesh(device="cpu")
    g = convert.gaussian_map_from_numpy(gmap, "cpu")
    s = opt.init(g)
    buf = convert.keyframe_buffer_from_numpy(kfbuf, "cpu")
    res = mapping_run(g, s, buf, window, torch.Generator().manual_seed(seed), iteration_count, n_iters,
                      intr=intr, rcfg=rcfg, opt=opt, mcfg=mcfg, mesh=mesh)
    return {"gmap": convert.gaussian_map_to_numpy(g), "opt": convert.adam_state_to_numpy(s),
            "kfbuf": convert.keyframe_buffer_to_numpy(buf), "last_loss": float(res.last_loss),
            "occ_visibility": _np(res.occ_visibility), "iteration_count": res.iteration_count}


def track_sharded(rank, scene, cam, intr, rcfg, tcfg):
    """track_camera_sharded over every rank."""
    from lvdgs_torch import convert
    from lvdgs_torch.parallel import make_mesh
    from lvdgs_torch.slam.tracking import track_camera_sharded

    mesh = make_mesh(device="cpu")
    params = {f: torch.tensor(scene[f]) for f in PARAM_FIELDS}
    res = track_camera_sharded(params, torch.tensor(scene["active"]), convert.camera_from_numpy(cam, "cpu"),
                               intr, rcfg, tcfg, mesh)
    return {k: (v if isinstance(v, int) else _np(v)) for k, v in res._asdict().items()}


def slam_state(slam) -> dict:
    """The SLAM's final map, poses and keyframes."""
    from lvdgs_torch import convert

    return {"gmap": convert.gaussian_map_to_numpy(slam.gmap), "kf_indices": list(slam.kf_indices),
            "poses": {i: np.concatenate([np.ravel(f["R"]), np.ravel(f["T"])]) for i, f in slam.frames.items()}}


def slam_run(rank, config, out_dir):
    """SLAM.run with Performance.data_parallel on a mesh over every rank,
    saving into out_dir/rank<r>; then save_state to rank 0's directory
    and, after a barrier, a fresh SLAM on each rank loads it."""
    from lvdgs_torch.eval.ate import eval_ate
    from lvdgs_torch.parallel import make_mesh
    from lvdgs_torch.slam.system import SLAM

    mesh = make_mesh(device="cpu")
    save_dir = os.path.join(out_dir, f"rank{rank}")
    slam = SLAM(config, save_dir=save_dir, device="cpu", mesh=mesh)
    results = slam.run(progress=False)
    ate = eval_ate(slam.frames, slam.kf_indices, None, len(slam.frames), final=True, monocular=True)
    ckpt = os.path.join(out_dir, "rank0", "checkpoint")
    slam.save_state(ckpt)
    dist.barrier()
    loaded = SLAM(config, save_dir=None, device="cpu", mesh=mesh)
    loaded.load_state(ckpt)
    state = slam_state(slam)
    return {**state, "ate": float(ate), "psnr": float(results["mean_psnr"]),
            "n_keyframes": results["n_keyframes"], "sharded": slam.mesh is not None,
            "loaded": slam_state(loaded), "loaded_opt_count": loaded.opt_state.count,
            "opt_count": slam.opt_state.count,
            "seqs": sorted({f["seq"] for f in slam.frames.values()}),
            "files": sorted(os.path.relpath(os.path.join(d, f), save_dir)
                            for d, _, fs in os.walk(save_dir) for f in fs)}


def cli_run(rank, argv):
    """python -m lvdgs_torch's main() in a rank of this world."""
    from lvdgs_torch.__main__ import main

    res = main(argv)
    return {k: v for k, v in res.items() if k in ("n_frames", "n_keyframes", "ate_rmse", "mean_psnr")}


def raise_on_rank_1(rank):
    """Rank 1 raises, rank 0 returns."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def hang_on_rank_1(rank):
    """Rank 1 waits far past any test's timeout, rank 0 returns."""
    import time

    if rank == 1:
        time.sleep(600)
    return rank
