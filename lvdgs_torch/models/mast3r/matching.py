"""Fast reciprocal nearest-neighbour descriptor matching (PyTorch port of
``lvdgs_tpu/models/mast3r/matching.py``).

The matcher the SLAM loop runs every tracked frame: from a subsampled
pixel grid of image 1, iterate NN(1 -> 2) then NN(2 -> 1) until the cycle
converges; the converged fixed points are reciprocal matches. Scores are
descriptor dot products, computed as blocked matmuls on the device; the
loop runs a fixed number of iterations and never waits on the device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _nn_blocked(queries: torch.Tensor, db: torch.Tensor, block: int = 2**13) -> torch.Tensor:
    """argmax_j queries @ db[j] over the rows of db, in blocks of `block`
    rows; an earlier block keeps a tie. (Q, D), (N, D) -> (Q,) int64."""
    Q = queries.shape[0]
    best_val = torch.full((Q,), -torch.inf, dtype=torch.float32, device=queries.device)
    best_idx = torch.zeros((Q,), dtype=torch.int64, device=queries.device)
    for start in range(0, db.shape[0], block):
        scores = queries @ db[start:start + block].T
        val, idx = scores.max(dim=1)
        better = val > best_val
        best_val = torch.where(better, val, best_val)
        best_idx = torch.where(better, idx + start, best_idx)
    return best_idx


def _fast_nn(desc1: torch.Tensor, desc2: torch.Tensor, subsample: int, max_iters: int, block: int):
    H1, W1, D = desc1.shape
    P1, P2 = desc1.reshape(-1, D), desc2.reshape(-1, D)
    dev = desc1.device
    ys = torch.arange(subsample // 2, H1, subsample, device=dev)
    xs = torch.arange(subsample // 2, W1, subsample, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    idx1 = (yy * W1 + xx).reshape(-1)
    idx2 = torch.zeros_like(idx1)
    conv = torch.zeros(idx1.shape, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        new_idx2 = _nn_blocked(P1[idx1], P2, block)
        new_idx1 = _nn_blocked(P2[new_idx2], P1, block)
        now = (new_idx1 == idx1) & ~conv
        # converged entries stay frozen
        idx2 = torch.where(conv, idx2, new_idx2)
        idx1 = torch.where(conv | now, idx1, new_idx1)
        conv = conv | now
    return idx1, idx2, conv


def fast_reciprocal_nns(desc1, desc2, subsample: int = 8, max_iters: int = 10, block: int = 2**13,
                        device=None) -> Tuple[np.ndarray, np.ndarray]:
    """desc1 (H1, W1, D), desc2 (H2, W2, D): tensors (matched on their
    device) or arrays (matched on `device`, default the CPU). Returns
    (matches_im1 (M, 2), matches_im2 (M, 2)) as (x, y) int arrays on the
    host, unique pairs in row order of the pair index."""
    if not isinstance(desc1, torch.Tensor):
        desc1 = torch.as_tensor(np.asarray(desc1), device=device)
    desc1 = desc1.to(torch.float32)
    desc2 = torch.as_tensor(np.asarray(desc2) if not isinstance(desc2, torch.Tensor) else desc2,
                            dtype=torch.float32, device=desc1.device)
    W1, W2 = desc1.shape[1], desc2.shape[1]
    idx1, idx2, conv = _fast_nn(desc1, desc2, subsample, max_iters, block)
    pairs = torch.stack([idx1[conv], idx2[conv]], dim=1).cpu().numpy()
    pairs = np.unique(pairs, axis=0)
    m1 = np.stack([pairs[:, 0] % W1, pairs[:, 0] // W1], axis=1)
    m2 = np.stack([pairs[:, 1] % W2, pairs[:, 1] // W2], axis=1)
    return m1, m2
