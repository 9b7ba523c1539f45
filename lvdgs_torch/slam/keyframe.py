"""Keyframe selection and window management (PyTorch port of
``lvdgs_tpu/slam/keyframe.py``): translation vs median-depth checks plus
covisibility overlap for `is_keyframe`; covisibility cut-off eviction, then
inverse-distance eviction, for `add_to_window`."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.log import sync


def _overlap_ratio_union(vis_a: torch.Tensor, vis_b: torch.Tensor) -> float:
    union = int(torch.count_nonzero(vis_a | vis_b))
    inter = int(torch.count_nonzero(vis_a & vis_b))
    return inter / max(union, 1)


def visibility_pair_stats(curr_vis: torch.Tensor, last_vis: torch.Tensor) -> torch.Tensor:
    """[count(curr), count(last), count(inter), count(union)]."""
    cv = curr_vis.to(torch.int32)
    lv = last_vis.to(torch.int32)
    return torch.stack([cv.sum(), lv.sum(), (cv * lv).sum(), torch.maximum(cv, lv).sum()])


def visibility_window_stats(curr_vis: torch.Tensor, occ_stack: torch.Tensor) -> torch.Tensor:
    """(n, 3) [inter, count(occ), count(curr)] against each window keyframe."""
    cv = curr_vis.to(torch.int32)
    o = occ_stack.to(torch.int32)
    inter = (o * cv[None, :]).sum(dim=1)
    with sync():
        n_curr = int(cv.sum())
    return torch.stack([inter, o.sum(dim=1), torch.full_like(inter, n_curr)], dim=1)


def _overlap_ratio_min(vis_a: torch.Tensor, vis_b: torch.Tensor) -> float:
    denom = min(int(torch.count_nonzero(vis_a)), int(torch.count_nonzero(vis_b)))
    inter = int(torch.count_nonzero(vis_a & vis_b))
    return inter / max(denom, 1)


def rel_translation(R_a: np.ndarray, T_a: np.ndarray, R_b: np.ndarray, T_b: np.ndarray) -> float:
    """||(T_cw_a @ T_wc_b)[:3, 3]|| for w2c poses a, b."""
    Ta = np.eye(4)
    Ta[:3, :3], Ta[:3, 3] = R_a, T_a
    Tb = np.eye(4)
    Tb[:3, :3], Tb[:3, 3] = R_b, T_b
    return float(np.linalg.norm((Ta @ np.linalg.inv(Tb))[:3, 3]))


def is_keyframe(
    *,
    curr_R: np.ndarray,
    curr_T: np.ndarray,
    last_kf_R: np.ndarray,
    last_kf_T: np.ndarray,
    median_depth: float,
    curr_visibility: torch.Tensor,
    last_kf_visibility: torch.Tensor,
    kf_translation: float,
    kf_min_translation: float,
    kf_overlap: float,
    static_ratio: Optional[float] = None,
    overlap_stats: Optional[np.ndarray] = None,
) -> bool:
    """Keyframe test: far enough relative to the median depth, or little
    enough covisible overlap (relaxed x0.7 for mostly-dynamic frames)."""
    dist = rel_translation(curr_R, curr_T, last_kf_R, last_kf_T)
    dist_check = dist > kf_translation * median_depth
    dist_check2 = dist > kf_min_translation * median_depth
    adjusted_overlap = kf_overlap
    if static_ratio is not None and static_ratio < 0.3:
        adjusted_overlap = kf_overlap * 0.7
    if overlap_stats is not None:
        point_ratio = int(overlap_stats[2]) / max(int(overlap_stats[3]), 1)
    else:
        point_ratio = _overlap_ratio_union(curr_visibility, last_kf_visibility)
    return (point_ratio < adjusted_overlap and dist_check2) or dist_check


def add_to_window(
    *,
    cur_frame_idx: int,
    curr_visibility: torch.Tensor,
    occ_visibility: Dict[int, torch.Tensor],
    window: List[int],
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
    window_size: int,
    kf_cutoff: float,
    initialized: bool,
    overlap_min_ratios: Optional[Dict[int, float]] = None,
) -> Tuple[List[int], Optional[int]]:
    """Insert the new keyframe at the window's front and evict. Returns
    (window, removed frame or None)."""
    N_dont_touch = 2
    window = [cur_frame_idx] + window
    removed_frame = None

    to_remove = []
    for i in range(N_dont_touch, len(window)):
        kf_idx = window[i]
        if overlap_min_ratios is not None:
            ratio = overlap_min_ratios[kf_idx]
        else:
            ratio = _overlap_ratio_min(curr_visibility, occ_visibility[kf_idx])
        cut_off = kf_cutoff if initialized else 0.4
        if ratio <= cut_off and len(window) > window_size:
            to_remove.append(kf_idx)
    if to_remove:
        window.remove(to_remove[-1])
        removed_frame = to_remove[-1]

    if len(window) > window_size:
        curr_R, curr_T = poses[cur_frame_idx]
        inv_dist = []
        for i in range(N_dont_touch, len(window)):
            inv_dists = []
            R_i, T_i = poses[window[i]]
            for j in range(N_dont_touch, len(window)):
                if i == j:
                    continue
                R_j, T_j = poses[window[j]]
                inv_dists.append(1.0 / (rel_translation(R_i, T_i, R_j, T_j) + 1e-6))
            k = np.sqrt(rel_translation(R_i, T_i, curr_R, curr_T))
            inv_dist.append(k * sum(inv_dists))
        idx = int(np.argmax(inv_dist))
        removed_frame = window[N_dont_touch + idx]
        window.remove(removed_frame)

    return window, removed_frame
