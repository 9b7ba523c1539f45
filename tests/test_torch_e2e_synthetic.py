"""End-to-end SLAM of the port on the synthetic dataset, on the CPU: the
port's copy of tests/test_e2e_synthetic.py, with the same run and the same
thresholds (ATE < 0.08, PSNR > 17), and of its checkpoint-resume test."""
import os

import numpy as np
import pytest

from lvdgs_torch.core.config import load_config
from lvdgs_torch.io.ply import load_gaussians_ply
from lvdgs_torch.slam.system import SLAM

pytestmark = pytest.mark.slow

CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "mono", "synthetic", "base_config.yaml")


@pytest.fixture(scope="module")
def slam_results(tmp_path_factory):
    config = load_config(CFG_PATH)
    config["Dataset"]["n_frames"] = 14
    config["Training"]["init_itr_num"] = 400
    config["Training"]["mapping_itr_num"] = 40
    config["Training"]["tracking_itr_num"] = 40
    # the reference's default, which its own e2e test runs with
    config["Training"]["mono_scale_servo"] = True
    config["Results"]["color_refinement_iters"] = 200
    save_dir = str(tmp_path_factory.mktemp("slam_out"))
    slam = SLAM(config, save_dir=save_dir, device="cpu")
    results = slam.run(progress=False)
    return slam, results, save_dir


def test_e2e_runs_and_tracks(slam_results):
    _, results, _ = slam_results
    assert results["n_frames"] == 14
    assert results["n_keyframes"] >= 2
    assert results["ate_rmse"] < 0.08, results


def test_e2e_rendering_quality(slam_results):
    _, results, _ = slam_results
    assert results["mean_psnr"] > 17.0, results


def test_e2e_artifacts_and_ply_roundtrip(slam_results):
    slam, _, save_dir = slam_results
    path = os.path.join(save_dir, "point_cloud", "final", "point_cloud.ply")
    plots = os.listdir(os.path.join(save_dir, "plot"))
    assert any(p.startswith("stats_final") for p in plots)
    means, *_ = load_gaussians_ply(path)
    active = slam.gmap.active.cpu().numpy()
    assert means.shape[0] == int(active.sum())
    np.testing.assert_allclose(means.sum(), float(slam.gmap.means.cpu().numpy()[active].sum()), rtol=1e-4)


def test_checkpoint_resume(tmp_path):
    """Port copy of tests/test_e2e_synthetic.py::test_checkpoint_resume: save
    mid-run, resume in a fresh SLAM, results stay sane."""
    config = load_config(CFG_PATH)
    config["Dataset"]["n_frames"] = 10
    config["Training"]["init_itr_num"] = 200
    config["Training"]["mapping_itr_num"] = 20
    config["Training"]["tracking_itr_num"] = 20
    config["Results"]["color_refinement"] = False
    config["Results"]["eval_rendering"] = False

    s1 = SLAM(config, save_dir=str(tmp_path / "a"), device="cpu")
    for i in range(6):
        s1.process_frame(i)
    ck = str(tmp_path / "ck")
    s1.save_state(ck)

    s2 = SLAM(config, save_dir=str(tmp_path / "b"), device="cpu")
    s2.load_state(ck)
    assert s2.frames_processed == s1.frames_processed
    assert s2.kf_indices == s1.kf_indices
    np.testing.assert_allclose(s2.gmap.means.numpy(), s1.gmap.means.numpy(), atol=0)
    res = s2.run(progress=False)
    assert res["n_frames"] == 10
    assert res["ate_rmse"] < 0.2
