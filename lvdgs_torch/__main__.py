"""Entry point: python -m lvdgs_torch --config configs/mono/synthetic/base_config.yaml

Loads the layered YAML config, builds the dynamic-object masker
(`dynamic_filtering`; its `grounding_dino_checkpoint` and `sam_checkpoint`
load GroundingDINO and SAM onto the device), the dataset, Gaussian map and SLAM system on the
chosen device (CUDA by default), runs the SLAM loop, then colour
refinement and the final evaluation. When `mast3r.checkpoint` names a file
that exists, the MASt3R network is loaded from it onto the device and its
fused pose and depth priors and scale remedy are handed to SLAM.
`--checkpoint-every N` saves the state to <save-dir>/checkpoint every N
frames; `--resume FILE` continues a run from such a file.

Multi-device: with `Performance.data_parallel` and more than one visible
GPU, it starts one rank per GPU (NCCL, lvdgs_torch.parallel.launch) and
every rank runs the SLAM on a mesh over all of them; rank 0 writes the
results. Called in a rank of a process group it runs on that group's
world, and under torchrun (WORLD_SIZE in the environment) it joins the
world torchrun describes: NCCL on CUDA, gloo with --device cpu.
"""
import argparse
import math
import os
import sys
import time


def _parse(argv):
    parser = argparse.ArgumentParser(description="LVD-GS SLAM (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--n-frames", type=int, default=None,
                        help="limit the number of processed frames")
    parser.add_argument("--save-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' runs the plain kernels)")
    parser.add_argument("--no-color-refinement", action="store_true")
    parser.add_argument("--no-eval-rendering", action="store_true")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume from a checkpoint file (<save-dir>/checkpoint of an earlier run)")
    parser.add_argument("--checkpoint-every", type=int, default=None,
                        help="save a resumable checkpoint every N frames")
    return parser.parse_args(argv)


def main(argv=None):
    import torch
    import torch.distributed as dist

    from lvdgs_torch.core.config import load_config

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    config = load_config(args.config)
    if not (config.get("Performance", {}) or {}).get("data_parallel", False):
        return _run(args, config)
    on_cuda = args.device is None or torch.device(args.device).type == "cuda"
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        # one rank of a world started outside: the caller's process group,
        # or the one torchrun describes
        join = not dist.is_initialized()
        if join:
            dist.init_process_group("nccl" if on_cuda else "gloo", init_method="env://")
        try:
            return _run_on_mesh(args, config)
        finally:
            if join:
                dist.destroy_process_group()
    n = torch.cuda.device_count() if on_cuda and torch.cuda.is_available() else 1
    if n > 1:
        from lvdgs_torch.parallel.launch import spawn

        return spawn(_rank_main, n, backend="nccl", args=(argv,), timeout=1800.0, join_timeout=math.inf)[0]
    return _run(args, config)


def _rank_main(rank: int, argv):
    """One rank of the world that main() launched."""
    from lvdgs_torch.core.config import load_config

    args = _parse(argv)
    return _run_on_mesh(args, load_config(args.config))


def _run_on_mesh(args, config):
    from lvdgs_torch.parallel.mesh import make_mesh, rank_device

    # the rank's own GPU (cuda:<local rank>), or the CPU with --device cpu
    device = None if args.device is None or args.device.startswith("cuda") else args.device
    mesh = make_mesh(device=device)
    return _run(args, config, mesh=mesh, device=rank_device(device))


def _run(args, config, mesh=None, device=None):
    from lvdgs_torch.core.log import Log
    from lvdgs_torch.perception import build_masker
    from lvdgs_torch.slam.system import SLAM

    device = args.device if device is None else device
    save_dir = args.save_dir
    if save_dir is None:
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        save_dir = os.path.join(config.get("Results", {}).get("save_dir", "results"), stamp)
    if mesh is None or mesh.get_rank() == 0:
        os.makedirs(save_dir, exist_ok=True)

    # MASt3R pointmap priors (pose seed and mono depth from one fused
    # forward per tracked frame, and the scale remedy) when a checkpoint is
    # configured
    priors = {}
    ckpt = (config.get("mast3r", {}) or {}).get("checkpoint")
    if ckpt and os.path.exists(ckpt):
        from lvdgs_torch.data.datasets import load_dataset
        from lvdgs_torch.models.mast3r.inference import (
            MASt3RInference, make_fused_priors, make_scale_remedy,
        )
        from lvdgs_torch.slam.system import resolve_device

        model = MASt3RInference.from_checkpoint(ckpt, device=resolve_device(device))
        ds = load_dataset(None, "", config, model.device)
        depth_prior, pose_prior = make_fused_priors(model, ds.intrinsics, ds.dist_coeffs)
        priors = dict(depth_prior=depth_prior, pose_prior=pose_prior, scale_remedy=make_scale_remedy(model))
        Log(f"MASt3R fused priors enabled from {ckpt}")

    slam = SLAM(config, save_dir=save_dir, device=device, masker=build_masker(config, device), mesh=mesh,
                **priors)
    if args.no_color_refinement:
        slam.do_color_refinement = False
    if args.no_eval_rendering:
        slam.do_eval_rendering = False
    if args.resume:
        slam.load_state(args.resume)
        Log(f"Resumed from {args.resume} at frame {slam.frames_processed}")
    results = slam.run(n_frames=args.n_frames, checkpoint_every=args.checkpoint_every)
    Log(f"Results: {results}", tag="Eval")
    return results


if __name__ == "__main__":
    main()
