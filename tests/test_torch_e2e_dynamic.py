"""End-to-end dynamic-scene proof of the port on the CPU: the port's copy of
tests/test_e2e_dynamic.py, with the same scene, runs and claims. Moving cars
in the street scene degrade unmasked SLAM; masking through the real plumbing
(the camera's static mask gates seeding and the static-region metrics)
recovers the degradation. As in the original, the oracle masker is assigned
after construction, so the mapping loss stays plain in both runs."""
import copy

import numpy as np
import pytest

from lvdgs_torch.eval.ate import eval_ate
from lvdgs_torch.eval.rendering import eval_rendering
from lvdgs_torch.perception.oracle import OracleLadderMasker, OracleMasker
from lvdgs_torch.slam.system import SLAM
from test_torch_dynamic import _dyn_config

pytestmark = pytest.mark.slow

N_FRAMES = 18


def _run(masked: bool):
    slam = SLAM(copy.deepcopy(_dyn_config(n_frames=N_FRAMES)), save_dir=None, device="cpu")
    if masked:
        slam.masker = OracleMasker(slam.dataset)
    for i in range(N_FRAMES):
        slam.process_frame(i)
    ate = float(eval_ate(slam.frames, slam.kf_indices, None, 0, final=True, monocular=True))
    metrics = eval_rendering(slam.gmap, slam.frames, slam.dataset, slam.intr, slam.rcfg, save_dir=None,
                             kf_indices=slam.kf_indices, iteration="dyn")
    return slam, ate, metrics


@pytest.fixture(scope="module")
def dynamic_runs():
    return _run(masked=False), _run(masked=True)


def test_scene_has_moving_objects(dynamic_runs):
    (slam_u, _, _), _ = dynamic_runs
    ds = slam_u.dataset
    m0 = ds.get_gt_static_mask(0).numpy()
    mL = ds.get_gt_static_mask(N_FRAMES - 1).numpy()
    assert 0.005 < 1.0 - m0.mean() < 0.6
    assert 0.005 < 1.0 - mL.mean() < 0.6
    assert (m0 != mL).mean() > 0.005


def test_masking_recovers_trajectory(dynamic_runs):
    (_, ate_u, _), (_, ate_m, _) = dynamic_runs
    assert np.isfinite(ate_m) and np.isfinite(ate_u)
    assert ate_m < ate_u, (ate_m, ate_u)


def test_masking_recovers_static_psnr(dynamic_runs):
    (_, _, m_u), (_, _, m_m) = dynamic_runs
    assert "mean_psnr_static" in m_m and "mean_psnr_static" in m_u
    assert m_m["mean_psnr_static"] > m_u["mean_psnr_static"], (m_m["mean_psnr_static"],
                                                              m_u["mean_psnr_static"])


def test_oracle_ladder_mask_quality():
    from lvdgs_torch.data.datasets import load_dataset

    ds = load_dataset(None, "", _dyn_config(n_frames=N_FRAMES), "cpu")
    masker = OracleLadderMasker(ds)
    img, _, _, _ = ds[8]
    static = masker.get_static_mask(img.numpy(), frame_idx=8)
    gt_static = ds.get_gt_static_mask(8).numpy()
    pred_dyn, gt_dyn = ~np.asarray(static), ~gt_static
    inter = float((pred_dyn & gt_dyn).sum())
    union = float((pred_dyn | gt_dyn).sum())
    assert gt_dyn.sum() > 0
    assert inter / max(union, 1.0) > 0.5, inter / max(union, 1.0)
