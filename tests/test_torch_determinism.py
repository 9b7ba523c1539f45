"""What keeps the port's SLAM run repeatable and its street run on track:
the gather's deterministic transpose (ops/rasterizer._gather_rows) and the
sim_prior map scale observed at the init keyframe (slam/system.py)."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from lvdgs_torch.core.config import load_config
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.slam.system import SLAM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_CFG = os.path.join(ROOT, "configs", "mono", "synthetic", "base_config.yaml")


@pytest.mark.parametrize("idx_shape, fields", [
    ((5, 32, 8), (10,)),    # packed chunks (NB, KC, TG)
    ((64, 12), (10,)),      # a dense (K, T) block, mostly sentinel
    ((3, 32, 8), (10, 7)),  # the widened (field, Jacobian) table
])
def test_gather_transpose_is_index_add_in_index_order(idx_shape, fields):
    """Forward as index_select; backward equal bit for bit to index_add_ on
    the CPU (which adds in index order, as the card's sort does) for every
    row but the sentinel, whose gradient is 0; and it repeats."""
    rng = np.random.default_rng(0)
    C = 40
    table = torch.from_numpy(rng.standard_normal((C + 1, *fields)).astype(np.float32))
    table[C] = 0.0
    idx = torch.from_numpy(rng.integers(0, C + 1, size=idx_shape))
    if len(idx_shape) == 2:
        idx[:, 3:] = C  # most of the block is empty slots
    cot = torch.from_numpy(rng.standard_normal((*idx_shape, *fields)).astype(np.float32))

    def grad_of(gather):
        t = table.clone().requires_grad_(True)
        out = gather(t)
        return out, torch.autograd.grad(out, t, cot)[0]

    out, g = grad_of(lambda t: tr._gather_rows(t, idx))
    ref_out, ref_g = grad_of(lambda t: torch.index_select(t, 0, idx.reshape(-1)).view(out.shape))
    assert torch.equal(out, ref_out)
    assert torch.equal(g[:C], ref_g[:C])
    assert not bool(g[C].any())
    assert torch.equal(grad_of(lambda t: tr._gather_rows(t, idx))[1], g)


def _sim_prior_slam(scale_at_init: bool, mono_scale_error: float) -> SLAM:
    """A small sim_prior SLAM with its init frame processed."""
    cfg = load_config(BASE_CFG)
    cfg["Dataset"]["n_frames"] = 2
    cfg["Dataset"]["mono_scale_error"] = mono_scale_error
    cfg["Dataset"]["Calibration"].update({"fx": 60.0, "fy": 60.0, "width": 64, "height": 48,
                                          "cx": 32.0, "cy": 24.0})
    cfg["Training"].update({"init_itr_num": 30, "pose_seed": "sim_prior", "mono_scale_servo": False,
                            "sim_prior_scale_at_init": scale_at_init})
    cfg["Results"].update({"save_results": False, "eval_rendering": False})
    cfg["Performance"].update({"max_per_tile": 64, "tile_chunk": 16, "map_capacity": 8192,
                               "kf_capacity": 16})
    slam = SLAM(cfg, save_dir=None, device="cpu")
    slam.process_frame(0)
    return slam


@pytest.mark.parametrize("mono_scale_error", [0.8, 1.25])
def test_sim_prior_map_scale_from_the_init_keyframe(mono_scale_error):
    """A mono depth off by a factor puts the init map off by that factor:
    the prior's scale is observed at the init keyframe (median rendered
    depth over GT depth), so frame 1's seed is already in map scale. The
    observation reads the map, so it moves by that factor against a map
    with a true mono depth (the small scene's median depth itself reads a
    little short)."""
    true_map = _sim_prior_slam(True, 1.0)
    slam = _sim_prior_slam(True, mono_scale_error)
    assert [f for f, _ in slam._scale_history] == [0]
    ratio = slam._map_scale_estimate() / true_map._map_scale_estimate()
    assert abs(ratio - mono_scale_error) < 0.02 * mono_scale_error, ratio


def test_sim_prior_scale_at_init_off_keeps_the_reference_fallback():
    """With Training.sim_prior_scale_at_init False the prior runs at 1.0
    until the second keyframe, as the reference's does."""
    slam = _sim_prior_slam(False, 0.8)
    assert slam._map_scale_obs is None and slam._scale_history == []
    assert slam._map_scale_estimate() == 1.0
