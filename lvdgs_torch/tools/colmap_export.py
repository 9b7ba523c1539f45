"""Export a saved SLAM run to COLMAP (database.db and a sparse text model).

The estimated poses become image pose priors, the Gaussian map becomes
points3D, and with --match-keyframes reciprocal-NN matches of MASt3R
descriptors between consecutive keyframes fill keypoints and matches for
COLMAP's triangulation or bundle adjustment downstream. The descriptors
come from the checkpoint named by LVDGS_MAST3R_CKPT, or else from the
ground-truth oracle (synthetic data). Runs on --device (the card by
default).

Run: python -m lvdgs_torch.tools.colmap_export --config <cfg> --checkpoint <file> \
     --out <dir> [--match-keyframes] [--device cpu]
"""
import argparse
import os


def keyframe_matcher(slam, model):
    """matcher(a, b) -> (xy_a (M, 2), xy_b (M, 2)): frames a and b through
    `model`'s infer_pair and fast_reciprocal_nns on the SLAM's device, in
    full-resolution pixels."""
    import numpy as np

    from lvdgs_torch.models.mast3r.matching import fast_reciprocal_nns

    def matcher(a, b):
        p1, p2, (H, W) = model.infer_pair(slam.dataset[a][0], slam.dataset[b][0])
        m1, m2 = fast_reciprocal_nns(p1["desc"][0], p2["desc"][0], device=slam.device)
        # matches lie at the model's prediction resolution
        scale = np.array([slam.intr.width / W, slam.intr.height / H], np.float32)
        return m1 * scale, m2 * scale

    return matcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True, help="a SLAM.save_state file")
    ap.add_argument("--out", required=True)
    ap.add_argument("--match-keyframes", action="store_true",
                    help="fill keypoints and matches between consecutive keyframes from MASt3R "
                         "descriptors (a checkpoint named by LVDGS_MAST3R_CKPT, else the ground-truth "
                         "oracle on synthetic data)")
    ap.add_argument("--device", default="cuda", help="where the SLAM state and models live (cuda or cpu)")
    args = ap.parse_args(argv)

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.io.colmap import export_slam_to_colmap
    from lvdgs_torch.slam.system import SLAM

    slam = SLAM(load_config(args.config), save_dir=None, device=args.device)
    slam.load_state(args.checkpoint)

    matcher = pairs = None
    if args.match_keyframes:
        ckpt = os.environ.get("LVDGS_MAST3R_CKPT")
        if ckpt:
            from lvdgs_torch.models.mast3r.inference import MASt3RInference

            model = MASt3RInference.from_checkpoint(ckpt, device=slam.device)
        else:
            from lvdgs_torch.models.mast3r.oracle import OracleMASt3R

            model = OracleMASt3R(slam.dataset, slam.intr)
        matcher = keyframe_matcher(slam, model)
        kfs = sorted(slam.kf_indices)
        pairs = list(zip(kfs[:-1], kfs[1:]))

    db = export_slam_to_colmap(slam, args.out, match_pairs=pairs, matcher=matcher)
    print(f"COLMAP export written: {db} + {args.out}/sparse/")


if __name__ == "__main__":
    main()
