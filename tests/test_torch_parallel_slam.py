"""The port's SLAM with Performance.data_parallel on two gloo ranks on the
CPU, against its single-device run; and (slow) the street-scale data-
parallel run against the reference's own.

The ranks are processes started by lvdgs_torch.parallel.launch.spawn (the
workers are in tests/torch_parallel_workers.py); each builds its SLAM on a
mesh over both. They must end bit for bit equal, rank 0 alone writes the
results, and a checkpoint that rank 0 writes loads on both ranks. The
end-to-end tolerances are the reference's (tests/test_parallel.py:
263-337): ATE within max(0.10, 40%) and PSNR within 2 dB of the
single-device run, with the keyframe cadence pinned (kf_overlap 1.1) so
that reduction-order noise cannot switch the runs between keyframe
regimes.
"""
import copy
import os

import numpy as np
import pytest

import torch_parallel_workers as workers
from lvdgs_torch.core.config import load_config
from lvdgs_torch.eval.ate import eval_ate
from lvdgs_torch.parallel.launch import spawn
from lvdgs_torch.slam.system import SLAM

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASE_CFG = os.path.join(ROOT, "configs", "mono", "synthetic", "base_config.yaml")
TIMEOUT = 120.0


def _small_dp_config(n_frames):
    """The port's small SLAM config (test_torch_slam._small_slam_config)
    with the keyframe cadence pinned, saving results, data-parallel."""
    cfg = load_config(BASE_CFG)
    cfg["Dataset"]["n_frames"] = n_frames
    cfg["Dataset"]["Calibration"].update({"fx": 60.0, "fy": 60.0, "width": 64, "height": 48,
                                          "cx": 32.0, "cy": 24.0})
    cfg["Training"].update({"init_itr_num": 60, "mapping_itr_num": 10, "tracking_itr_num": 10,
                            "kf_interval": 2, "mono_scale_servo": False, "kf_overlap": 1.1})
    cfg["Results"].update({"save_results": True, "eval_rendering": True, "color_refinement": True,
                           "color_refinement_iters": 5})
    cfg["Performance"].update({"max_per_tile": 64, "tile_chunk": 16, "map_capacity": 8192,
                               "kf_capacity": 16, "data_parallel": True})
    return cfg


def _single(cfg, n_frames):
    cfg = copy.deepcopy(cfg)
    cfg["Performance"]["data_parallel"] = False
    slam = SLAM(cfg, save_dir=None, device="cpu")
    slam.save_results = False
    res = slam.run(progress=False)
    ate = float(eval_ate(slam.frames, slam.kf_indices, None, n_frames, final=True, monocular=True))
    return ate, float(res["mean_psnr"]), res["n_keyframes"]


def test_two_rank_slam_matches_single_device(tmp_path):
    # 10 frames: 5 keyframes and 5 eval frames. At 7 the PSNR is taken over
    # 3 frames, and the sharded tracker (packed at max_per_tile, as the
    # reference's) moved it 2.3 dB from the single-device tracker's (dense
    # on the CPU) on one rank alone, past the 2 dB.
    n_frames = 10
    cfg = _small_dp_config(n_frames)
    outs = spawn(workers.slam_run, 2, backend="gloo", device="cpu", args=(cfg, str(tmp_path)),
                 timeout=TIMEOUT, join_timeout=2 * TIMEOUT)
    r0, r1 = outs
    assert r0["sharded"] and r1["sharded"]
    # each rank's frame records carry its rank as their sequence id
    assert (r0["seqs"], r1["seqs"]) == ([0], [1])
    # the replicas: every map field, pose and keyframe bit for bit
    assert r0["kf_indices"] == r1["kf_indices"]
    for k, v in r0["gmap"].items():
        np.testing.assert_array_equal(v, r1["gmap"][k], err_msg=k)
    assert r0["poses"].keys() == r1["poses"].keys()
    for i in r0["poses"]:
        np.testing.assert_array_equal(r0["poses"][i], r1["poses"][i], err_msg=f"frame {i}")
    # rank 0 alone writes; its checkpoint loads on both ranks, each equal
    # to the state rank 0 saved (and so to its own)
    assert "point_cloud/final/point_cloud.ply" in r0["files"] and "checkpoint" in r0["files"]
    assert r1["files"] == []
    for r in outs:
        assert r["loaded"]["kf_indices"] == r0["kf_indices"] and r["loaded_opt_count"] == r0["opt_count"]
        for k, v in r["loaded"]["gmap"].items():
            np.testing.assert_array_equal(v, r0["gmap"][k], err_msg=k)
        for i in r0["poses"]:
            np.testing.assert_array_equal(r["loaded"]["poses"][i], r0["poses"][i])
    assert r0["n_keyframes"] >= 2
    ate_sd, psnr_sd, _ = _single(cfg, n_frames)
    assert np.isfinite(r0["ate"]) and np.isfinite(r0["psnr"])
    assert abs(r0["ate"] - ate_sd) < max(0.10, 0.40 * ate_sd), (r0["ate"], ate_sd)
    assert abs(r0["psnr"] - psnr_sd) < 2.0, (r0["psnr"], psnr_sd)



def test_cli_runs_on_the_callers_world(tmp_path):
    """python -m lvdgs_torch's main() called in each of two gloo ranks with
    a data-parallel config and --device cpu runs the SLAM on a mesh over
    that world: both ranks report the same run, and rank 0 writes its
    results (the final ATE and map)."""
    import yaml

    cfg = _small_dp_config(3)
    cfg["Training"]["init_itr_num"] = 20
    cfg["Results"]["color_refinement"] = False
    cfg["Results"]["eval_rendering"] = False
    path = tmp_path / "dp.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(path), "--device", "cpu", "--save-dir", str(tmp_path / "out")]
    r0, r1 = spawn(workers.cli_run, 2, backend="gloo", device="cpu", args=(argv,), timeout=TIMEOUT,
                   join_timeout=TIMEOUT)
    assert {k: v for k, v in r0.items() if k != "ate_rmse"} == r1 and r0["n_frames"] == 3
    assert np.isfinite(r0["ate_rmse"]) and "ate_rmse" not in r1
    assert (tmp_path / "out" / "point_cloud" / "final" / "point_cloud.ply").exists()


def test_launch_reports_a_failed_or_hung_rank():
    """spawn raises with a rank's traceback when it raises, and raises
    TimeoutError when it outlives the join timeout; no rank is left
    running either way."""
    import multiprocessing

    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank 1 fails"):
        spawn(workers.raise_on_rank_1, 2, backend="gloo", device="cpu", timeout=30.0, join_timeout=60.0)
    with pytest.raises(TimeoutError, match=r"ranks \[1\] still running"):
        spawn(workers.hang_on_rank_1, 2, backend="gloo", device="cpu", timeout=30.0, join_timeout=15.0)
    assert not multiprocessing.active_children()

def _street_config(dp: bool):
    """The reference's street-scale parity config (tests/test_parallel.py:
    263-337)."""
    config = load_config(BASE_CFG)
    config["Dataset"].update({
        "scene": "street", "n_frames": 16, "step": 0.5, "accel_frames": 4, "street_half_width": 8.0,
        "street_spacing": 0.5, "photo_gain_jitter": 0.0, "photo_bias_jitter": 0.0, "photo_noise": 0.0,
        "mono_scale_error": 1.0, "mono_noise": 0.0, "pcd_downsample": 16, "pcd_downsample_init": 8,
    })
    config["Dataset"]["Calibration"].update({"width": 160, "height": 48, "fx": 95.0, "fy": 95.0,
                                             "cx": 80.0, "cy": 24.0})
    config["Training"].update({
        "pose_seed": "constant_velocity", "init_itr_num": 250, "mapping_itr_num": 25,
        "tracking_itr_num": 30, "kf_interval": 3, "window_size": 6, "single_thread": True,
        "kf_overlap": 1.1,
    })
    config["Results"].update({"save_results": False, "eval_rendering": False, "color_refinement": False})
    config["Performance"] = {"tile_size": 16, "max_per_tile": 128, "gaussian_chunk": 16, "tile_chunk": 32,
                             "map_capacity": 16384, "kf_capacity": 32, "data_parallel": dp}
    return config


@pytest.mark.slow
def test_street_scale_dp_matches_reference_dp(tmp_path):
    """The street-scale data-parallel run on 8 ranks against the
    reference's own on its 8 virtual devices: ATE within max(0.10, 40%),
    PSNR within 2 dB, and the ranks bit for bit equal."""
    import jax

    from lvdgs_tpu.eval.ate import eval_ate as jeval_ate
    from lvdgs_tpu.eval.rendering import eval_rendering as jeval_rendering
    from lvdgs_tpu.slam.system import SLAM as JSLAM

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jslam = JSLAM(_street_config(True), save_dir=None)
    assert jslam.mesh is not None
    for i in range(16):
        jslam.process_frame(i)
    ate_ref = float(jeval_ate(jslam.frames, jslam.kf_indices, None, 0, final=True, monocular=True))
    psnr_ref = jeval_rendering(jslam.gmap, jslam.frames, jslam.dataset, jslam.intr, jslam.rcfg, save_dir=None,
                               kf_indices=jslam.kf_indices, iteration="dp_parity")["mean_psnr"]

    cfg = _street_config(True)
    cfg["Results"]["eval_rendering"] = True
    outs = spawn(workers.slam_run, 8, backend="gloo", device="cpu", args=(cfg, str(tmp_path)),
                 timeout=1800.0, join_timeout=3600.0)
    for r in outs[1:]:
        for k, v in outs[0]["gmap"].items():
            np.testing.assert_array_equal(v, r["gmap"][k], err_msg=k)
    ate, psnr = outs[0]["ate"], outs[0]["psnr"]
    assert abs(ate - ate_ref) < max(0.10, 0.40 * ate_ref), (ate, ate_ref)
    assert abs(psnr - psnr_ref) < 2.0, (psnr, psnr_ref)
