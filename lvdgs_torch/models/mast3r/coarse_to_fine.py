"""Coarse-to-fine matching: crop-pair selection and high-resolution match
refinement (port of ``lvdgs_tpu/models/mast3r/coarse_to_fine.py``).

A coarse full-image matching pass proposes correspondences; this module
selects a small set of (query crop, partner crop) window pairs that covers
them; each pair is re-matched at native resolution and the refined matches
are mapped back to full-image coordinates.

- windows lie on a fixed-stride grid with 16-px-aligned sizes (the model's
  constraint), and each query window's partner is sized from the median and
  the robust spread of its correspondences' positions in the other image;
- pair selection is a weighted maximum-coverage greedy on a dense
  (pairs x correspondences) weight matrix, until `coverage` of the
  attainable weight is covered;
- `refine_matches` drives any model with `infer_pair` (the network,
  `MASt3RInference`, or the ground-truth `OracleMASt3R`) through
  `fast_reciprocal_nns` per crop pair, then dedupes the union. A crop pair
  whose two crops preprocess to different shapes runs through the
  network's two-shape forward, and each view's matches scale by its own
  model resolution; a crop too thin to keep one patch once preprocessed
  (a model's `fits`) is skipped. The reference raises in both cases.

Everything here is host NumPy: the crop geometry is data-dependent and
tiny. The model's forwards and the matching run where the model's outputs
lie (a network's on its device), and each pair's matches come back to the
host as NumPy.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .matching import fast_reciprocal_nns


def _align16(v: int) -> int:
    return max(16, (int(v) // 16) * 16)


def window_grid(H: int, W: int, maxdim: int = 512,
                overlap: float = 0.5) -> np.ndarray:
    """(N, 4) int windows [l, t, r, b] tiling (H, W).

    Window size is the image scaled so its long edge is `maxdim` (what one
    model forward natively covers), 16-aligned; start positions are evenly
    spaced with at least `overlap` fraction of overlap between neighbours.
    """
    assert 0.0 <= overlap < 1.0
    s = maxdim / max(H, W)
    wh, ww = _align16(min(H, round(H * s))), _align16(min(W, round(W * s)))

    def starts(total, win):
        if total <= win:
            return np.zeros(1, np.int64)
        step = max(1, int(win * (1.0 - overlap)))
        n = 2 + (total - win - 1) // step
        return np.linspace(0, total - win, n).round().astype(np.int64)

    ys, xs = starts(H, wh), starts(W, ww)
    gx, gy = np.meshgrid(xs, ys)
    l, t = gx.ravel(), gy.ravel()
    return np.stack([l, t, l + ww, t + wh], axis=1)


def _partner_windows(cells_q: np.ndarray, p_q: np.ndarray, p_b: np.ndarray,
                     Hb: int, Wb: int, min_corres: int = 10
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each query window, place a partner window in the other image
    around where that window's correspondences land.

    Returns (cells_q', cells_b, member (N', M) bool) keeping only windows
    with >= min_corres member correspondences."""
    x, y = p_q[:, 0], p_q[:, 1]
    member = (
        (cells_q[:, None, 0] <= x) & (x < cells_q[:, None, 2])
        & (cells_q[:, None, 1] <= y) & (y < cells_q[:, None, 3])
    )  # (N, M)
    keep = member.sum(axis=1) >= min_corres
    cells_q, member = cells_q[keep], member[keep]
    if not len(cells_q):
        return cells_q, cells_q.copy(), member

    pb = np.where(member[:, :, None], p_b[None].astype(np.float64), np.nan)
    center = np.nanmedian(pb, axis=1)  # (N', 2)
    q10 = np.nanquantile(pb, 0.1, axis=1)
    q90 = np.nanquantile(pb, 0.9, axis=1)
    pq = np.where(member[:, :, None], p_q[None].astype(np.float64), np.nan)
    s10 = np.nanquantile(pq, 0.1, axis=1)
    s90 = np.nanquantile(pq, 0.9, axis=1)
    # partner size = query size scaled by the robust spread ratio
    size_q = (cells_q[:, 2:4] - cells_q[:, 0:2]).astype(np.float64)
    ratio = np.clip(q90 - q10, 20.0, None) / np.clip(s90 - s10, 20.0, None)
    size_b = size_q * ratio
    size_b = np.stack(
        [np.clip(size_b[:, 0], 16, Wb), np.clip(size_b[:, 1], 16, Hb)], axis=1
    )
    size_b = (size_b // 16 * 16).astype(np.int64)
    half = size_b / 2.0
    lt = np.round(center - half).astype(np.int64)
    # shift fully inside the image
    lt[:, 0] = np.clip(lt[:, 0], 0, Wb - size_b[:, 0])
    lt[:, 1] = np.clip(lt[:, 1], 0, Hb - size_b[:, 1])
    cells_b = np.concatenate([lt, lt + size_b], axis=1)
    return cells_q, cells_b, member


def _coverage_weights(cells_q, cells_b, p_q, p_b, member,
                      sharpness: float = 2.0) -> np.ndarray:
    """(N, M) weights: how well pair n covers correspondence m — product of
    gaussian falloffs from each window's center (normalized by window
    size), zero for non-members."""

    def w(cells, p):
        c = (cells[:, 0:2] + cells[:, 2:4]) / 2.0
        size = np.clip((cells[:, 2:4] - cells[:, 0:2]), 1, None)
        d = (c[:, None] - p[None]) / size[:, None]
        return np.exp(-sharpness * np.square(d).sum(-1))

    return np.where(member, w(cells_q, p_q) * w(cells_b, p_b), 0.0)


def greedy_cover(weights: np.ndarray, coverage: float = 0.9,
                 max_pairs: Optional[int] = None) -> List[int]:
    """Weighted max-coverage greedy: pick rows of `weights` until the
    per-correspondence max over picked rows reaches `coverage` of the
    attainable total. Returns picked row indices in pick order."""
    assert 0.0 < coverage <= 1.0
    n, m = weights.shape
    if n == 0 or m == 0:
        return []
    attainable = weights.max(axis=0).sum()
    if attainable <= 0:
        return []
    covered = np.zeros(m)
    picked: List[int] = []
    gain = weights.copy()
    limit = n if max_pairs is None else min(n, max_pairs)
    while covered.sum() < coverage * attainable and len(picked) < limit:
        best = int(gain.sum(axis=1).argmax())
        if gain[best].sum() <= 0:
            break
        picked.append(best)
        covered = np.maximum(covered, weights[best])
        gain = np.clip(weights - covered[None], 0.0, None)
    return picked


def select_crop_pairs(shape_q: Tuple[int, int], shape_b: Tuple[int, int],
                      p_q: np.ndarray, p_b: np.ndarray, maxdim: int = 512,
                      overlap: float = 0.5, coverage: float = 0.9,
                      min_corres: int = 10,
                      max_pairs: Optional[int] = None
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Coarse matches -> [(cell_q [l,t,r,b], cell_b)] crop pairs covering
    them. Symmetric: windows are proposed from both images' grids."""
    p_q = np.asarray(p_q, np.float64)
    p_b = np.asarray(p_b, np.float64)
    Hq, Wq = shape_q
    Hb, Wb = shape_b
    cq1, cb1, m1 = _partner_windows(
        window_grid(Hq, Wq, maxdim, overlap), p_q, p_b, Hb, Wb, min_corres
    )
    cb2, cq2, m2 = _partner_windows(
        window_grid(Hb, Wb, maxdim, overlap), p_b, p_q, Hq, Wq, min_corres
    )
    cells_q = np.concatenate([cq1, cq2], axis=0)
    cells_b = np.concatenate([cb1, cb2], axis=0)
    member = np.concatenate([m1, m2], axis=0)
    if not len(cells_q):
        return []
    weights = _coverage_weights(cells_q, cells_b, p_q, p_b, member)
    order = greedy_cover(weights, coverage, max_pairs)
    return [(cells_q[i], cells_b[i]) for i in order]


def refine_matches(model, img1: np.ndarray, img2: np.ndarray,
                   maxdim: int = 512, overlap: float = 0.5,
                   coverage: float = 0.9, subsample: int = 8,
                   max_pairs: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Full coarse-to-fine pipeline on a MASt3RInference-compatible model.

    imgs: (3, H, W) float [0, 1]. A full-image coarse pass proposes
    matches; selected crop pairs are re-matched natively and mapped back.
    Returns (m1 (M, 2), m2 (M, 2)) full-resolution (x, y) int matches
    (the coarse set is the fallback when no crop pair qualifies)."""
    _, H1, W1 = img1.shape
    _, H2, W2 = img2.shape
    pred1, pred2, _ = model.infer_pair(img1, img2)
    (h1, w1), (h2, w2) = pred1["desc"].shape[1:3], pred2["desc"].shape[1:3]
    c1, c2 = fast_reciprocal_nns(pred1["desc"][0], pred2["desc"][0],
                                 subsample=subsample)
    # model-resolution -> full-resolution coordinates, each view at its own
    # model resolution (the reference takes view 1's for both, which is
    # the same where the two views' shapes agree)
    f1 = c1 * np.array([W1 / w1, H1 / h1])
    f2 = c2 * np.array([W2 / w2, H2 / h2])
    pairs = select_crop_pairs((H1, W1), (H2, W2), f1, f2, maxdim, overlap,
                              coverage, max_pairs=max_pairs)
    if not pairs:
        return f1.round().astype(np.int64), f2.round().astype(np.int64)
    out1, out2 = [], []
    fits = getattr(model, "fits", lambda crop: True)
    for cell1, cell2 in pairs:
        l1, t1, r1, b1 = cell1
        l2, t2, r2, b2 = cell2
        crop1 = img1[:, t1:b1, l1:r1]
        crop2 = img2[:, t2:b2, l2:r2]
        if not (fits(crop1) and fits(crop2)):
            continue  # too thin for one patch at the model's resolution
        p1, p2, _ = model.infer_pair(crop1, crop2)
        (ch1, cw1), (ch2, cw2) = p1["desc"].shape[1:3], p2["desc"].shape[1:3]
        m1, m2 = fast_reciprocal_nns(p1["desc"][0], p2["desc"][0],
                                     subsample=subsample)
        if not len(m1):
            continue
        s1 = np.array([(r1 - l1) / cw1, (b1 - t1) / ch1])
        s2 = np.array([(r2 - l2) / cw2, (b2 - t2) / ch2])
        out1.append(m1 * s1 + np.array([l1, t1]))
        out2.append(m2 * s2 + np.array([l2, t2]))
    if not out1:
        return f1.round().astype(np.int64), f2.round().astype(np.int64)
    m1 = np.concatenate(out1).round().astype(np.int64)
    m2 = np.concatenate(out2).round().astype(np.int64)
    pairs_arr = np.unique(np.concatenate([m1, m2], axis=1), axis=0)
    return pairs_arr[:, :2], pairs_arr[:, 2:]
