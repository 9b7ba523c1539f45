"""Absolute trajectory error with Umeyama alignment (copy of
``lvdgs_tpu/eval/ate.py``; NumPy only).

Replaces the reference's evo dependency (utils/eval_utils_0806.py:33-98):
estimated keyframe w2c poses are inverted to camera centers, Umeyama-aligned
to ground truth (with scale correction for monocular, as evo's
`align(correct_scale=True)`), and the APE translation RMSE is reported.
Includes the reference's robustness ladder: degenerate-trajectory detection
falls back to unaligned / translation-only comparison instead of raising.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.log import Log


def umeyama_alignment(
    x: np.ndarray, y: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning columns of x onto y.

    x, y: (3, N). Returns (R, t, c) with y ≈ c * R @ x + t.
    """
    n = x.shape[1]
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = ((x - mean_x[:, None]) ** 2).sum() / n
    cov = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = float(np.trace(np.diag(d) @ S) / max(sigma_x, 1e-12)) if with_scale else 1.0
    t = mean_y - c * R @ mean_x
    return R, t, c


def ate_rmse(
    est_w2c: List[np.ndarray],
    gt_w2c: List[np.ndarray],
    monocular: bool = True,
) -> Dict[str, float]:
    """APE translation RMSE after (scaled) Umeyama alignment."""
    est_centers = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in est_w2c], axis=1)
    gt_centers = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in gt_w2c], axis=1)

    # non-finite poses (diverged tracking) poison the SVD: score only the
    # finite subset and report how many were dropped (reference wraps the
    # whole evo alignment in try/except, utils/eval_utils_0806.py:40-63)
    finite = np.isfinite(est_centers).all(axis=0) & np.isfinite(gt_centers).all(
        axis=0
    )
    n_bad = int((~finite).sum())
    if n_bad:
        Log(
            f"ATE: dropping {n_bad}/{finite.size} non-finite keyframe poses "
            "(tracking diverged)",
            tag="Eval",
        )
        if not finite.any():
            return {"rmse": float("inf"), "mean": float("inf"),
                    "median": float("inf"), "std": 0.0, "min": float("inf"),
                    "max": float("inf"), "aligned": False, "scale": 1.0,
                    "n_dropped": n_bad}
        est_centers = est_centers[:, finite]
        gt_centers = gt_centers[:, finite]

    # diversity check (reference fallback, utils/eval_utils_0806.py:40-63)
    spread = est_centers.std(axis=1).max()
    if est_centers.shape[1] < 3 or spread < 1e-8:
        err = np.linalg.norm(est_centers - gt_centers, axis=0)
        return {
            "rmse": float(np.sqrt((err**2).mean())),
            "mean": float(err.mean()),
            "median": float(np.median(err)),
            "std": float(err.std()),
            "min": float(err.min()),
            "max": float(err.max()),
            "aligned": False,
            "scale": 1.0,
            "n_dropped": n_bad,
        }

    R, t, c = umeyama_alignment(est_centers, gt_centers, with_scale=monocular)
    aligned = c * R @ est_centers + t[:, None]
    err = np.linalg.norm(aligned - gt_centers, axis=0)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "aligned": True,
        "scale": c,
        "n_dropped": n_bad,
    }


def eval_ate(
    frames: Dict[int, dict],
    kf_ids: List[int],
    save_dir: Optional[str],
    iterations: int,
    final: bool = False,
    monocular: bool = True,
    label: Optional[str] = None,
) -> float:
    """Reference eval_ate parity (utils/eval_utils_0806.py:101-169).

    `frames` maps frame_idx -> {"R": (3,3), "T": (3,), "R_gt", "T_gt"}
    (numpy). Saves trj_{label}.json + stats_{label}.json under
    save_dir/plot when save_dir is given.
    """
    if len(kf_ids) == 0:
        return 0.0
    trj_est, trj_gt, trj_est_np, trj_gt_np = [], [], [], []
    for kf_id in kf_ids:
        f = frames[kf_id]
        w2c_est = np.eye(4)
        w2c_est[:3, :3], w2c_est[:3, 3] = f["R"], f["T"]
        w2c_gt = np.eye(4)
        w2c_gt[:3, :3], w2c_gt[:3, 3] = f["R_gt"], f["T_gt"]
        trj_est.append(np.linalg.inv(w2c_est).tolist())
        trj_gt.append(np.linalg.inv(w2c_gt).tolist())
        trj_est_np.append(w2c_est)
        trj_gt_np.append(w2c_gt)

    stats = ate_rmse(trj_est_np, trj_gt_np, monocular=monocular)
    label = label or (f"final" if final else f"{iterations}")
    Log(f"ATE RMSE [{label}]: {stats['rmse']:.6f} (scale {stats['scale']:.4f})", tag="Eval")

    if save_dir is not None:
        plot_dir = os.path.join(save_dir, "plot")
        os.makedirs(plot_dir, exist_ok=True)
        with open(os.path.join(plot_dir, f"trj_{label}.json"), "w") as f:
            json.dump({"trj_est": trj_est, "trj_gt": trj_gt}, f)
        with open(os.path.join(plot_dir, f"stats_{label}.json"), "w") as f:
            json.dump(stats, f, indent=2)
        _plot_trajectory(trj_est_np, trj_gt_np, os.path.join(plot_dir, f"trj_{label}.png"))
    return stats["rmse"]


def _plot_trajectory(est_w2c, gt_w2c, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        est = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in est_w2c])
        gt = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in gt_w2c])
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot(gt[:, 0], gt[:, 2], "k--", label="GT")
        ax.plot(est[:, 0], est[:, 2], "b-", label="Est")
        ax.legend()
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.set_aspect("equal", "datalim")
        fig.savefig(path, dpi=90)
        plt.close(fig)
    except Exception:  # pragma: no cover — plotting is best-effort (matplotlib optional)
        pass
