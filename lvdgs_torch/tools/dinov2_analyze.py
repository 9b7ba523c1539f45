"""DINOv2 feature analyser.

Per-layer feature-norm heatmaps, class-token attention maps, token PCA
heatmaps and a feature-evolution summary for one image; the forward
returns every block's tokens and attention maps. Weights: a torch.hub
dinov2_vitb14 state dict (--checkpoint), or seeded random weights for a
structure-only analysis. Runs on --device (the card by default).

Usage: python -m lvdgs_torch.tools.dinov2_analyze --image img.png --output out/
       [--checkpoint dinov2_vitb14.pth] [--layers 0 5 11] [--device cpu]
"""
import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--output", default="./dinov2_analysis")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--model", default="vitb14")
    ap.add_argument("--layers", type=int, nargs="*", default=None)
    ap.add_argument("--side", type=int, default=518, help="the square input size, a multiple of 14")
    ap.add_argument("--device", default="cuda", help="where the model runs (cuda or cpu)")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch
    from PIL import Image

    from lvdgs_torch.models.dinov2.model import DINOv2Config, dinov2_forward, init_params, load_hub

    cfg = DINOv2Config()
    if args.checkpoint and os.path.exists(args.checkpoint):
        model = load_hub(args.checkpoint, cfg, device=args.device)
        print(f"loaded checkpoint {args.checkpoint}")
    else:
        gen = torch.Generator(device=args.device).manual_seed(0)
        model = init_params(cfg, gen, args.device).eval()
        print("WARNING: no checkpoint — random weights (structure analysis only)")

    img = Image.open(args.image).convert("RGB").resize((args.side, args.side))
    x = np.asarray(img, np.float32) / 255.0
    x = (x - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]
    x = torch.as_tensor(x.transpose(2, 0, 1)[None], dtype=torch.float32, device=args.device)

    out = dinov2_forward(model, x)
    h, w = out["grid"]
    os.makedirs(args.output, exist_ok=True)
    layers = args.layers or list(range(cfg.depth))

    stats = []
    for li in layers:
        tok = out["tokens"][li][0, 1:].cpu().numpy()  # (N, D)
        att = out["attn"][li][0].cpu().numpy()  # (heads, 1+N, 1+N)
        heat = np.linalg.norm(tok, axis=-1).reshape(h, w)
        plt.imsave(os.path.join(args.output, f"layer{li:02d}_featnorm.png"), heat, cmap="viridis")
        cls_att = att[:, 0, 1:].mean(0).reshape(h, w)
        plt.imsave(os.path.join(args.output, f"layer{li:02d}_clsattn.png"), cls_att, cmap="inferno")
        # the tokens' first three principal components as RGB
        tc = tok - tok.mean(0)
        u, s, _vt = np.linalg.svd(tc, full_matrices=False)
        pca = (u[:, :3] * s[:3]).reshape(h, w, 3)
        pca = (pca - pca.min()) / (np.ptp(pca) + 1e-9)
        plt.imsave(os.path.join(args.output, f"layer{li:02d}_pca.png"), pca)
        stats.append({"layer": li, "feat_norm_mean": float(heat.mean()), "feat_std": float(tok.std()),
                      "attn_entropy": float(-(att * np.log(att + 1e-9)).sum(-1).mean())})

    fig, ax = plt.subplots(1, 2, figsize=(10, 4))
    ax[0].plot([s["layer"] for s in stats], [s["feat_norm_mean"] for s in stats], "o-")
    ax[0].set_title("feature norm by layer")
    ax[1].plot([s["layer"] for s in stats], [s["attn_entropy"] for s in stats], "o-")
    ax[1].set_title("attention entropy by layer")
    fig.savefig(os.path.join(args.output, "feature_evolution.png"), dpi=90)
    plt.close(fig)

    with open(os.path.join(args.output, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(f"wrote analysis for {len(layers)} layers to {args.output}")


if __name__ == "__main__":
    main()
