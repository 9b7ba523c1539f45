"""Per-frame trace of the street run on the card: where each frame's camera
ended against the ground truth, which frames became keyframes, and the map
scale that the sim_prior pose seed used.

    python -m lvdgs_torch.tools.street_trace [--frames 20] [--bf16 | --dense]
        [--reference-prior-scale] [--index-select-gather]

It drives SLAM on configs/mono/synthetic/street.yaml as chip_smoke.py does
(packed as configured, or with blend_bf16, or dense; mono_scale_servo off)
and prints one line per frame: the map scale the seed used, whether the
frame became a keyframe, and the estimated and ground-truth camera centres
(the map, and so the estimate, is at the mono depth's scale, about 0.8 of
the world's). Then the keyframes, the scale observations and the ATE RMSE
over the keyframes, as chip_smoke.py computes it.

--reference-prior-scale sets Training.sim_prior_scale_at_init to False:
the seed runs at scale 1.0 until the second keyframe, as the reference's
does. --index-select-gather puts index_select's own transpose (the atomics
of index_add_, which add in another order each run) in place of
_gather_rows' deterministic one, to sample the run-to-run spread that the
port had before. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..core.config import load_config
from ..eval.ate import eval_ate
from ..ops import rasterizer as tr
from ..slam.system import SLAM
from .timing import card_line

STREET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "configs", "mono", "synthetic", "street.yaml")


def _index_select_gather(table, idx):
    return torch.index_select(table, 0, idx.reshape(-1)).view(*idx.shape, *table.shape[1:])


def _centre(R, T) -> np.ndarray:
    R, T = np.asarray(R, dtype=np.float64), np.asarray(T, dtype=np.float64)
    return -R.T @ T


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=20)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--bf16", action="store_true", help="packed with Performance.blend_bf16")
    mode.add_argument("--dense", action="store_true", help="both packed budgets at 0")
    parser.add_argument("--reference-prior-scale", action="store_true",
                        help="Training.sim_prior_scale_at_init False")
    parser.add_argument("--index-select-gather", action="store_true",
                        help="the gather's transpose by index_add_'s atomics")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("street_trace needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.index_select_gather:
        tr._gather_rows = _index_select_gather

    config = load_config(STREET)
    perf = config["Performance"]
    if args.dense:
        perf["packed_tracking_budget"] = 0
        perf["packed_mapping_budget"] = 0
    perf["blend_bf16"] = args.bf16
    config["Training"]["mono_scale_servo"] = False
    config["Training"]["sim_prior_scale_at_init"] = not args.reference_prior_scale
    config["Results"]["eval_rendering"] = False
    config["Dataset"]["n_frames"] = args.frames
    label = ("bf16" if args.bf16 else "dense" if args.dense else "packed") + (
        ", reference prior scale" if args.reference_prior_scale else "") + (
        ", index_select gather" if args.index_select_gather else "")
    print(f"card: {card_line()}", flush=True)
    print(f"street trace [{label}]: {args.frames} frames", flush=True)

    slam = SLAM(config, save_dir=None, device=torch.device("cuda"))
    slam.run(progress=False)
    history = list(slam._scale_history)
    for i in sorted(slam.frames):
        f = slam.frames[i]
        seen = [s for k, s in history if k < i]
        scale = seen[-1] if seen else 1.0
        est, gt = _centre(f["R"], f["T"]), _centre(f["R_gt"], f["T_gt"])
        print(f"frame {i:2d}: seed scale {scale:.4f}{' keyframe' if i in slam.kf_indices else ''}; "
              f"centre {np.round(est, 3).tolist()}, ground truth {np.round(gt, 3).tolist()}",
              flush=True)
    ate = eval_ate(slam.frames, slam.kf_indices, None, args.frames, final=True, monocular=True)
    print(f"street trace [{label}]: keyframes {slam.kf_indices}, scale observations "
          f"{[(k, round(s, 4)) for k, s in history]}, ATE RMSE {ate:.4f} m", flush=True)


if __name__ == "__main__":
    main()
