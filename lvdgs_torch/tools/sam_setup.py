"""SAM checkpoint setup and self-test.

Validates a local checkpoint (a strict load onto --device, the card by
default, and a box-prompted predict on a random image) and optionally
points a config at it. Nothing is downloaded: place the file locally.

Usage: python -m lvdgs_torch.tools.sam_setup [--checkpoint sam_vit_b_01ec64.pth]
       [--config configs/mono/KITTI/base_config.yaml] [--device cpu]
"""
import argparse
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default="sam_vit_b_01ec64.pth")
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda", help="where SAM runs (cuda or cpu)")
    args = ap.parse_args()

    if not os.path.exists(args.checkpoint):
        print(f"checkpoint {args.checkpoint} not found.")
        print("Place the file locally (this tool downloads nothing):")
        print("  sam_vit_b_01ec64.pth (https://dl.fbaipublicfiles.com/segment_anything/)")
        return 1

    from lvdgs_torch.models.sam.inference import SAMSegmenter

    print("loading checkpoint...")
    seg = SAMSegmenter.from_checkpoint(args.checkpoint, device=args.device)
    print("running self-test (random image, one box)...")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, size=(256, 320, 3), dtype=np.uint8)
    masks = seg(img, np.asarray([[40, 40, 200, 180]], np.float32))
    print(f"self-test OK: mask shape {masks.shape}, positive px {int(masks.sum())}")

    if args.config:
        import yaml

        with open(args.config) as f:
            cfg = yaml.full_load(f)
        cfg.setdefault("dynamic_filtering", {})["sam_checkpoint"] = os.path.abspath(
            args.checkpoint
        )
        cfg["dynamic_filtering"]["use_sam"] = True
        with open(args.config, "w") as f:
            yaml.safe_dump(cfg, f)
        print(f"patched {args.config}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
