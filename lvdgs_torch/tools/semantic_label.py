"""Semantic mask labeller: per-class id masks, coloured masks and a batch
report.

Open-vocabulary detection of a class list, each class drawn in a stable
colour, an integer id mask written beside it, per-image JSON, a legend
strip, and a batch overview with per-class instance counts and pixel
coverage. All classes go through one grounded forward (a
"car . truck . ..." prompt with per-box phrase decoding); a detector
without phrase support falls back to one prompt per class. The models load
onto --device (the card by default).

Usage: python -m lvdgs_torch.tools.semantic_label --input imgs/ --output out/
       [--classes "car,person,building"] [--gdino ckpt] [--sam ckpt] [--device cpu]
"""
import argparse
import glob
import json
import os

import numpy as np

PALETTE = np.array(
    [[220, 20, 60], [0, 128, 255], [60, 180, 75], [255, 225, 25], [145, 30, 180],
     [245, 130, 48], [70, 240, 240], [240, 50, 230], [210, 245, 60], [0, 0, 128]],
    np.uint8,
)


def _detect_all(detector, img, classes, thr):
    """-> list of (class_idx, box, score) via one batched-prompt forward,
    falling back to per-class prompts when phrases are unsupported."""
    prompt = " . ".join(classes) + " ."
    try:
        boxes, scores, phrases = detector(img, prompt, thr, return_phrases=True)
        out = []
        for b, s, p in zip(boxes, scores, phrases):
            if p in classes:
                out.append((classes.index(p), b, float(s)))
        return out
    except TypeError:
        out = []
        for ci, cls in enumerate(classes):
            boxes, scores = detector(img, cls + " .", thr)
            out.extend((ci, b, float(s)) for b, s in zip(boxes, scores))
        return out


def _legend(classes, width):
    """Color legend strip (reference draws per-class color keys)."""
    from PIL import Image, ImageDraw

    row_h = 18
    im = Image.new("RGB", (width, row_h * len(classes)), (25, 25, 25))
    d = ImageDraw.Draw(im)
    for i, cls in enumerate(classes):
        c = tuple(int(v) for v in PALETTE[i % len(PALETTE)])
        d.rectangle([4, i * row_h + 3, 16, i * row_h + row_h - 3], fill=c)
        d.text((22, i * row_h + 3), f"{i + 1}: {cls}", fill=(255, 255, 255))
    return np.asarray(im)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="./semantic_labels")
    ap.add_argument("--classes", default="car,truck,bus,person,bicycle")
    ap.add_argument("--gdino", default=None)
    ap.add_argument("--sam", default=None)
    ap.add_argument("--box-threshold", type=float, default=0.35)
    ap.add_argument("--nms-iou", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", help="where the models run (cuda or cpu)")
    args = ap.parse_args()

    from PIL import Image

    from lvdgs_torch.tools.batch_detect import nms_xyxy

    detector = segmenter = None
    if args.gdino and os.path.exists(args.gdino):
        from lvdgs_torch.models.groundingdino.inference import load_detector

        detector = load_detector(args.gdino, device=args.device)
    if args.sam and os.path.exists(args.sam):
        from lvdgs_torch.models.sam.inference import load_segmenter

        segmenter = load_segmenter(args.sam, device=args.device)

    classes = [c.strip() for c in args.classes.split(",") if c.strip()]
    paths = sorted(
        sum((glob.glob(os.path.join(args.input, p)) for p in ("*.png", "*.jpg")), [])
    )
    os.makedirs(args.output, exist_ok=True)
    report = {"classes": classes, "images": []}
    total_counts = {c: 0 for c in classes}
    for path in paths:
        img = np.asarray(Image.open(path).convert("RGB"))
        H, W = img.shape[:2]
        id_mask = np.zeros((H, W), np.uint8)
        colored = img.copy()
        counts = {c: 0 for c in classes}
        coverage = {c: 0.0 for c in classes}
        if detector is not None:
            dets = _detect_all(detector, img, classes, args.box_threshold)
            if dets:
                bx = np.asarray([d[1] for d in dets], np.float64)
                sc = np.asarray([d[2] for d in dets], np.float64)
                dets = [dets[i] for i in nms_xyxy(bx, sc, args.nms_iou)]
            for ci, box, score in dets:
                cls = classes[ci]
                counts[cls] += 1
                x0, y0, x1, y1 = np.clip(np.asarray(box, int), 0, [W, H, W, H])
                if segmenter is not None:
                    m = segmenter(img, np.asarray([box], np.float32))[0]
                else:
                    m = np.zeros((H, W), bool)
                    m[y0:y1, x0:x1] = True
                id_mask[m] = ci + 1
                colored[m] = (
                    0.5 * colored[m] + 0.5 * PALETTE[ci % len(PALETTE)]
                ).astype(np.uint8)
            for ci, cls in enumerate(classes):
                coverage[cls] = float((id_mask == ci + 1).mean())
        name = os.path.splitext(os.path.basename(path))[0]
        Image.fromarray(id_mask).save(os.path.join(args.output, f"{name}_ids.png"))
        colored_with_legend = np.concatenate([colored, _legend(classes, W)], axis=0)
        Image.fromarray(colored_with_legend).save(
            os.path.join(args.output, f"{name}_colored.png"))
        entry = {"image": path, "counts": counts, "pixel_coverage": coverage,
                 "labeled_ratio": float((id_mask > 0).mean())}
        with open(os.path.join(args.output, f"{name}.json"), "w") as f:
            json.dump(entry, f, indent=2)
        report["images"].append(entry)
        for c, n in counts.items():
            total_counts[c] += n
        print(f"{name}: {counts if detector else 'no detector — empty masks'}")

    report["total_counts"] = total_counts
    report["mean_labeled_ratio"] = float(
        np.mean([e["labeled_ratio"] for e in report["images"]])
        if report["images"] else 0.0)
    with open(os.path.join(args.output, "label_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"report -> {os.path.join(args.output, 'label_report.json')}")


if __name__ == "__main__":
    main()
