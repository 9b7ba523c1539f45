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
"""
import argparse
import os
import time


def main(argv=None):
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
    args = parser.parse_args(argv)

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.core.log import Log
    from lvdgs_torch.perception import build_masker
    from lvdgs_torch.slam.system import SLAM

    config = load_config(args.config)
    save_dir = args.save_dir
    if save_dir is None:
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        save_dir = os.path.join(config.get("Results", {}).get("save_dir", "results"), stamp)
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

        model = MASt3RInference.from_checkpoint(ckpt, device=resolve_device(args.device))
        ds = load_dataset(None, "", config, model.device)
        depth_prior, pose_prior = make_fused_priors(model, ds.intrinsics, ds.dist_coeffs)
        priors = dict(depth_prior=depth_prior, pose_prior=pose_prior, scale_remedy=make_scale_remedy(model))
        Log(f"MASt3R fused priors enabled from {ckpt}")

    slam = SLAM(config, save_dir=save_dir, device=args.device, masker=build_masker(config, args.device),
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
