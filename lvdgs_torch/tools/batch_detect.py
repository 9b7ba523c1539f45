"""Batch dynamic/static detection report suite over an image folder.

Runs detection over every image in a folder and writes the full report
suite: per-class coloured overlays, contour-only overlays, a 2x2 overlay
grid (original / dynamic / static / complete), before-after comparisons,
per-image stats JSON, and a batch overview report with per-class counts.
Detections get greedy IoU NMS and a dynamic/static phrase classification.

Works model-free through the masking fallback ladder (flow and heuristics
give a dynamic mask but no class boxes) and produces the per-class suite
when GroundingDINO (and optionally SAM) checkpoints are given, which load
onto --device (the card by default).

Usage: python -m lvdgs_torch.tools.batch_detect --input imgs/ --output out/
       [--scene outdoor_street] [--gdino ckpt.pth] [--sam ckpt.pth] [--device cpu]
"""
import argparse
import glob
import json
import os
import time

import numpy as np

# classes the reference treats as static context (test_dino2.py create_prompts)
STATIC_CLASSES = (
    "building", "house", "tree", "pole", "traffic light", "traffic sign",
    "bench", "wall", "fence", "bridge", "parked car",
)


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.5):
    """Greedy IoU NMS (reference _apply_nms_with_sam, test_dino2.py:1205)."""
    if len(boxes) == 0:
        return np.zeros(0, int)
    order = np.argsort(-scores)
    keep = []
    area = (boxes[:, 2] - boxes[:, 0]).clip(0) * (boxes[:, 3] - boxes[:, 1]).clip(0)
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = (x2 - x1).clip(0) * (y2 - y1).clip(0)
        iou = inter / np.maximum(area[i] + area[rest] - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, int)


def draw_box(img: np.ndarray, box, color, label: str = ""):
    """Rectangle + label directly on an RGB uint8 array (no cv2 needed)."""
    H, W = img.shape[:2]
    x1, y1, x2, y2 = [int(np.clip(v, 0, lim - 1))
                      for v, lim in zip(box, (W, H, W, H))]
    t = max(1, min(H, W) // 300)
    img[y1:y1 + t, x1:x2] = color
    img[max(y2 - t, 0):y2, x1:x2] = color
    img[y1:y2, x1:x1 + t] = color
    img[y1:y2, max(x2 - t, 0):x2] = color
    try:
        import cv2

        cv2.putText(img, label, (x1 + 2, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, tuple(int(c) for c in color), 1)
    except Exception:
        pass
    return img


def mask_contours(mask: np.ndarray) -> np.ndarray:
    """Boolean edge map of a mask (contour overlay without cv2.findContours)."""
    m = mask.astype(bool)
    edge = np.zeros_like(m)
    edge[:-1] |= m[:-1] ^ m[1:]
    edge[:, :-1] |= m[:, :-1] ^ m[:, 1:]
    return edge & _dilate(m, 1)


def _dilate(m: np.ndarray, it: int) -> np.ndarray:
    for _ in range(it):
        p = np.pad(m, 1)
        m = (p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:] | p[1:-1, 1:-1])
    return m


def overlay_grid(panels, titles):
    """2x2 titled grid (reference _create_overlay_grid, test_dino2.py:600)."""
    from PIL import Image, ImageDraw

    h, w = panels[0].shape[:2]
    sc = min(1.0, 640 / w)
    tw, th = int(w * sc), int(h * sc)
    bar = 22
    canvas = Image.new("RGB", (tw * 2 + 6, (th + bar) * 2 + 6), (30, 30, 30))
    for i, (p, title) in enumerate(zip(panels, titles)):
        im = Image.fromarray(p).resize((tw, th))
        x = (i % 2) * (tw + 6)
        y = (i // 2) * (th + bar + 6)
        canvas.paste(im, (x, y + bar))
        ImageDraw.Draw(canvas).text((x + 4, y + 4), title, fill=(255, 255, 255))
    return np.asarray(canvas)


def before_after(original, overlay):
    """Side-by-side comparison (reference _create_before_after_comparison)."""
    return overlay_grid([original, overlay, original, overlay],
                        ["BEFORE", "AFTER", "", ""])[: original.shape[0] // 2 + 40]


def process_image(img, masker, viz, out_dirs, name, box_threshold):
    """One image through detect → NMS → classify → report suite. Returns the
    per-image report entry."""
    from PIL import Image

    from lvdgs_torch.eval.viz import mask_overlay

    H, W = img.shape[:2]
    t0 = time.time()
    detections = []  # (box, score, phrase, dynamic?)
    if masker.detector is not None:
        try:
            prompt = masker.prompt_manager.get_dynamic_prompt()
            out = masker.detector(img, prompt, box_threshold,
                                  return_phrases=True)
            boxes, scores, phrases = out
        except TypeError:  # detector without phrase support (HF wrapper)
            boxes, scores = masker.detector(img,
                                            masker.prompt_manager.get_dynamic_prompt())
            phrases = [""] * len(boxes)
        keep = nms_xyxy(np.asarray(boxes, np.float64),
                        np.asarray(scores, np.float64))
        for i in keep:
            ph = phrases[i] or "object"
            detections.append({
                "box": [round(float(v), 1) for v in boxes[i]],
                "score": round(float(scores[i]), 3),
                "phrase": ph,
                "dynamic": not any(s in ph for s in STATIC_CLASSES),
            })

    static = masker.get_static_mask(img, frame_idx=0)
    dynamic_mask = ~static
    dt = time.time() - t0

    # --- report suite
    # 1. plain dynamic-region overlay + static mask
    mask_overlay(img, dynamic_mask,
                 path=os.path.join(out_dirs["overlay"], f"{name}_overlay.png"))
    Image.fromarray((static * 255).astype(np.uint8)).save(
        os.path.join(out_dirs["mask"], f"{name}_static.png"))

    # 2. per-class colored box overlays, split dynamic/static
    dyn_img = img.copy()
    sta_img = img.copy()
    both = img.copy()
    for d in detections:
        color = viz.color_for(d["phrase"], d["dynamic"])
        label = f"{d['phrase']} {d['score']:.2f}"
        draw_box(both, d["box"], color, label)
        draw_box(dyn_img if d["dynamic"] else sta_img, d["box"], color, label)

    # 3. contour-only overlay (reference create_contour_only_overlay :1013)
    contour = img.copy()
    edge = mask_contours(_dilate(dynamic_mask, 1))
    contour[edge] = (255, 64, 64)

    # 4. 2x2 grid + before/after
    grid = overlay_grid(
        [img, dyn_img, sta_img, both],
        ["ORIGINAL", f"DYNAMIC ({sum(d['dynamic'] for d in detections)})",
         f"STATIC ({sum(not d['dynamic'] for d in detections)})",
         "ALL DETECTIONS"])
    Image.fromarray(grid).save(os.path.join(out_dirs["grid"], f"{name}_grid.png"))
    Image.fromarray(contour).save(
        os.path.join(out_dirs["contour"], f"{name}_contour.png"))
    ba = overlay_grid([img, both, contour, np.stack([static * 255] * 3, -1).astype(np.uint8)],
                      ["BEFORE", "AFTER", "CONTOURS", "STATIC MASK"])
    Image.fromarray(ba).save(
        os.path.join(out_dirs["compare"], f"{name}_before_after.png"))

    entry = {
        "image": name,
        "static_ratio": float(static.mean()),
        "n_detections": len(detections),
        "n_dynamic": int(sum(d["dynamic"] for d in detections)),
        "n_static": int(sum(not d["dynamic"] for d in detections)),
        "detections": detections,
        "seconds": round(dt, 3),
    }
    with open(os.path.join(out_dirs["json"], f"{name}.json"), "w") as f:
        json.dump(entry, f, indent=2)
    return entry


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="./batch_detection")
    ap.add_argument("--scene", default="outdoor_street")
    ap.add_argument("--gdino", default=None)
    ap.add_argument("--sam", default=None)
    ap.add_argument("--box-threshold", type=float, default=0.35)
    ap.add_argument("--device", default="cuda", help="where the models run (cuda or cpu)")
    args = ap.parse_args()

    from lvdgs_torch.perception.masking import (ColorfulSegmentationVisualizer,
                                              DynamicObjectMasker)

    masker = DynamicObjectMasker(
        scene_type=args.scene,
        grounding_dino_checkpoint=args.gdino,
        sam_checkpoint=args.sam,
        box_threshold=args.box_threshold,
        device=args.device,
    )
    viz = ColorfulSegmentationVisualizer()

    paths = sorted(
        sum((glob.glob(os.path.join(args.input, p))
             for p in ("*.png", "*.jpg", "*.jpeg")), [])
    )
    out_dirs = {k: os.path.join(args.output, k)
                for k in ("overlay", "mask", "grid", "contour", "compare", "json")}
    for d in out_dirs.values():
        os.makedirs(d, exist_ok=True)

    from PIL import Image

    report = {"scene": args.scene, "images": [], "started": time.strftime("%F %T")}
    t_start = time.time()
    for i, path in enumerate(paths):
        img = np.asarray(Image.open(path).convert("RGB"))
        name = os.path.splitext(os.path.basename(path))[0]
        entry = process_image(img, masker, viz, out_dirs, name,
                              args.box_threshold)
        report["images"].append(entry)
        print(f"[{i+1}/{len(paths)}] {name}: static {entry['static_ratio']:.1%}, "
              f"{entry['n_detections']} det ({entry['seconds']:.2f}s)")

    # batch overview (reference _save_batch_summary/_create_batch_overview)
    per_class = {}
    for e in report["images"]:
        for d in e["detections"]:
            per_class[d["phrase"]] = per_class.get(d["phrase"], 0) + 1
    report.update({
        "n_images": len(report["images"]),
        "total_seconds": round(time.time() - t_start, 1),
        "mean_static_ratio": float(
            np.mean([e["static_ratio"] for e in report["images"]])
            if report["images"] else 1.0),
        "mean_detections": float(
            np.mean([e["n_detections"] for e in report["images"]])
            if report["images"] else 0.0),
        "per_class_counts": dict(sorted(per_class.items(),
                                        key=lambda kv: -kv[1])),
    })
    with open(os.path.join(args.output, "batch_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"report -> {os.path.join(args.output, 'batch_report.json')}")


if __name__ == "__main__":
    main()
