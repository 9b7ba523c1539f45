"""Checkpoint and resume of the port (lvdgs_torch.io.checkpoint,
SLAM.save_state / load_state, run(checkpoint_every=...), python -m
lvdgs_torch --checkpoint-every / --resume), against the reference package
where both take the same inputs.

The port's CPU runs repeat bit for bit, so a run stopped after frame k and
resumed in a fresh SLAM must end bit for bit equal to an unbroken run: the
map and its Adam state, the keyframe buffer, every pose and the metrics.
The reference's key set is enough for that on these runs; the state it
leaves out (ROADMAP C9: `_last_resize_kf`, `_servo_obs`, the masker's
history and, read by the MASt3R priors, `_cams`) is shown by the last
tests, each where it changes what a resumed run does.
"""
import copy
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lvdgs_torch.core.config import load_config
from lvdgs_torch.eval.ate import eval_ate
from lvdgs_torch.io.checkpoint import load_checkpoint, save_checkpoint
from lvdgs_torch.slam.system import SLAM

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASE_CFG = os.path.join(ROOT, "configs", "mono", "synthetic", "base_config.yaml")
PARAMS = ("means", "features_dc", "log_scales", "quats", "logit_opacities")


def _small_slam_config(n_frames):
    """The port's small CPU recipe (tests/test_torch_slam.py)."""
    cfg = load_config(BASE_CFG)
    cfg["Dataset"]["n_frames"] = n_frames
    cfg["Dataset"]["Calibration"].update({"fx": 60.0, "fy": 60.0, "width": 64, "height": 48,
                                          "cx": 32.0, "cy": 24.0})
    cfg["Training"].update({"init_itr_num": 60, "mapping_itr_num": 10, "tracking_itr_num": 10,
                            "kf_interval": 2, "mono_scale_servo": False})
    cfg["Results"].update({"save_results": False, "eval_rendering": True, "color_refinement": True,
                           "color_refinement_iters": 5})
    cfg["Performance"].update({"max_per_tile": 64, "tile_chunk": 16, "map_capacity": 8192,
                               "kf_capacity": 16})
    return cfg


def _state(slam) -> dict:
    """Everything a resumed run must reproduce, as host arrays."""
    out = {f"map {f.name}": getattr(slam.gmap, f.name).numpy() for f in dataclasses.fields(slam.gmap)}
    for part in ("m", "v"):
        for k, v in getattr(slam.opt_state, part).items():
            out[f"adam {part} {k}"] = v.numpy()
    out["adam count"] = np.asarray(slam.opt_state.count)
    for f in dataclasses.fields(slam.kfbuf):
        out[f"kfbuf {f.name}"] = np.asarray(getattr(slam.kfbuf, f.name))
    for i, rec in slam.frames.items():
        for k in ("R", "T", "exposure_a", "exposure_b"):
            out[f"frame {i} {k}"] = np.asarray(rec[k])
    for k, v in slam.occ_visibility.items():
        out[f"occ {k}"] = v.numpy()
    out["rng"] = slam.generator.get_state().numpy()
    out["scalars"] = np.asarray([slam.iteration_count, slam.frames_processed, slam.median_depth,
                                 slam.idle_debt, slam.last_sent], np.float64)
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not differ, differ[:10]


# ---------------------------------------------------------------------------
# the checkpoint file


def test_checkpoint_roundtrip(tmp_path):
    """Port copy of tests/test_aux.py::test_checkpoint_roundtrip; the
    reference's save/load of the same state reads back the same values."""
    from lvdgs_tpu.io.checkpoint import load_checkpoint as jload
    from lvdgs_tpu.io.checkpoint import save_checkpoint as jsave

    state = {"a": torch.arange(5), "b": {"c": np.ones((2, 2)), "d": 3}}
    path = str(tmp_path / "ck")
    save_checkpoint(path, state)
    out = load_checkpoint(path)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(5))
    assert int(out["b"]["d"]) == 3
    # the reference, on the same values
    jpath = str(tmp_path / "ck_ref")
    jsave(jpath, {"a": jnp.arange(5), "b": {"c": np.ones((2, 2)), "d": 3}})
    jout = jload(jpath)
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(jout["a"]))
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.asarray(jout["b"]["c"]))
    assert int(jout["b"]["d"]) == int(out["b"]["d"])


def test_checkpoint_file_holds_only_weights_only_types(tmp_path):
    """NumPy arrays and scalars become tensors and Python scalars, None,
    tuples and int-keyed dicts survive, the file loads under
    weights_only=True onto the asked device, and anything else is refused."""
    path = str(tmp_path / "sub" / "ck")
    save_checkpoint(path, {"f": {3: {"R": np.eye(3, dtype=np.float32), "m": None, "e": 1.5}},
                           "h": [(1, 2.0)], "b": np.bool_(True), "g": torch.Generator().get_state()})
    out = torch.load(path, weights_only=True)
    assert out["f"][3]["R"].dtype == torch.float32 and out["f"][3]["m"] is None
    assert out["h"] == [(1, 2.0)] and out["b"] is True
    assert load_checkpoint(path, map_location="cpu")["g"].dtype == torch.uint8
    assert not os.path.exists(path + ".tmp")
    with pytest.raises(TypeError, match="set"):
        save_checkpoint(path, {"x": {1, 2}})


# ---------------------------------------------------------------------------
# stop and resume


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_resume_equals_unbroken_run(tmp_path, packed):
    """A run stopped after frame 2, saved, and resumed in a fresh SLAM ends
    bit for bit where the unbroken run ends: map, Adam state, keyframe
    buffer, poses, visibility, generator and counters, and the same ATE and
    PSNR (colour refinement and the eval after the resume included)."""
    cfg = _small_slam_config(6)
    if packed:
        cfg["Performance"].update({"packed_tracking_budget": 48, "packed_mapping_budget": 64})
    full = SLAM(copy.deepcopy(cfg), save_dir=str(tmp_path / "full"), device="cpu")
    res_full = full.run(progress=False)

    first = SLAM(copy.deepcopy(cfg), save_dir=str(tmp_path / "first"), device="cpu")
    first.do_color_refinement = first.do_eval_rendering = False
    first.run(n_frames=3, progress=False)
    path = str(tmp_path / "ck")
    first.save_state(path)
    second = SLAM(copy.deepcopy(cfg), save_dir=str(tmp_path / "second"), device="cpu")
    second.load_state(path)
    _assert_same(_state(second), _state(first))
    assert second.frames_processed == 3 and second.kf_indices == first.kf_indices
    res = second.run(progress=False)

    assert len(full.kf_indices) >= 3
    _assert_same(_state(second), _state(full))
    for k in ("n_frames", "n_keyframes", "mean_psnr", "mean_ssim"):
        assert res[k] == res_full[k], k
    ate = [eval_ate(s.frames, s.kf_indices, None, 6, final=True, monocular=True) for s in (second, full)]
    assert ate[0] == ate[1] and np.isfinite(ate[0])


def test_checkpoint_every_writes_the_state_and_optional_keys_default(tmp_path):
    """run(checkpoint_every=2) saves <save_dir>/checkpoint after frames 1
    and 3; its filled keyframe rows only; a checkpoint without the optional
    keys (idle_debt, last_sent, the scale observations) loads with the
    reference's defaults, and load_state clears the cached active count."""
    cfg = _small_slam_config(4)
    cfg["Results"].update({"color_refinement": False, "eval_rendering": False})
    slam = SLAM(copy.deepcopy(cfg), save_dir=str(tmp_path), device="cpu")
    slam.run(progress=False, checkpoint_every=2)
    path = str(tmp_path / "checkpoint")
    st = load_checkpoint(path)
    assert st["frames_processed"] == 4
    n = slam.kfbuf.count
    assert st["kfbuf"]["count"] == n and st["kfbuf"]["images_u8"].shape[0] == n
    assert st["kfbuf"]["capacity"] == slam.kfbuf.capacity
    for key in ("idle_debt", "last_sent", "anchor_scales", "mono_anchor_val", "map_scale_obs",
                "scale_history"):
        st.pop(key)
    bare = str(tmp_path / "bare")
    save_checkpoint(bare, st)
    other = SLAM(copy.deepcopy(cfg), device="cpu")
    other._cached_num_active = 12345
    other.load_state(bare)
    assert other._cached_num_active is None
    assert (other.idle_debt, other.last_sent, other._anchor_scales, other._mono_anchor_val,
            other._map_scale_obs, other._scale_history) == (0, 0, [], None, None, [])
    assert other._num_active_cached() == slam.gmap.num_active
    assert all(torch.equal(getattr(other.gmap, f), getattr(slam.gmap, f)) for f in PARAMS)


def test_cli_checkpoint_every_and_resume(tmp_path):
    """python -m lvdgs_torch --checkpoint-every 3 writes a checkpoint that
    --resume continues from, to the frame count asked."""
    from lvdgs_torch.__main__ import main

    cfg = _small_slam_config(4)
    cfg["Results"].update({"save_results": False, "eval_rendering": False, "color_refinement": False})
    cfg_path = str(tmp_path / "small.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    common = ["--config", cfg_path, "--device", "cpu"]
    first = main(common + ["--save-dir", str(tmp_path / "a"), "--n-frames", "3", "--checkpoint-every", "3"])
    ck = tmp_path / "a" / "checkpoint"
    assert first["n_frames"] == 3 and os.path.isfile(ck)
    assert load_checkpoint(str(ck))["frames_processed"] == 3
    resumed = main(common + ["--save-dir", str(tmp_path / "b"), "--resume", str(ck)])
    assert resumed["n_frames"] == 4 and resumed["n_keyframes"] >= first["n_keyframes"]


# ---------------------------------------------------------------------------
# what the reference's key set leaves out (ROADMAP C9)


def test_unsaved_last_resize_kf_lets_a_resumed_run_shrink_early(tmp_path):
    """`_last_resize_kf` (read by _maybe_shrink) is not saved: a map that
    grew at the last keyframe may not shrink for 5 keyframes, but after a
    resume it shrinks at once."""
    cfg = _small_slam_config(2)
    cfg["Performance"].update({"map_capacity": 2**15, "map_capacity_init": 2**14})
    run = SLAM(copy.deepcopy(cfg), device="cpu")
    run._grow_to(2**15)
    path = str(tmp_path / "ck")
    run.save_state(path)
    resumed = SLAM(copy.deepcopy(cfg), device="cpu")
    resumed.load_state(path)
    assert resumed.gmap.capacity == run.gmap.capacity == 2**15
    assert (run._last_resize_kf, resumed._last_resize_kf) == (0, -10)
    run._maybe_shrink()
    resumed._maybe_shrink()
    assert run.gmap.capacity == 2**15 and resumed.gmap.capacity == 2**14


def test_unsaved_servo_obs_changes_a_resumed_gauge(tmp_path):
    """`_servo_obs` (the mono-scale servo's recent observations) is not
    saved: at the same keyframe with the same depths, the unbroken run's
    servo sees a drifted median and rescales the world; the resumed one
    sees one observation on the anchor and does not."""
    cfg = _small_slam_config(2)
    cfg["Training"]["mono_scale_servo"] = True
    run = SLAM(copy.deepcopy(cfg), device="cpu")
    run._mono_anchor_val = 1.0
    run._servo_obs = [1.2, 1.2, 1.2, 1.2]
    path = str(tmp_path / "ck")
    run.save_state(path)
    resumed = SLAM(copy.deepcopy(cfg), device="cpu")
    resumed.load_state(path)
    assert resumed._mono_anchor_val == 1.0 and resumed._servo_obs == []
    H, W = run.intr.height, run.intr.width
    outs = []
    for slam in (run, resumed):
        cam = slam._build_camera(1)
        depth = torch.full((H, W), 5.0)
        cam = cam.replace(mono_depth=depth.clone())
        _fused, cam = slam._fused_keyframe_depth(1, cam, depth, init=False)
        outs.append(float(slam.median_depth))
    assert outs[0] != outs[1]
    assert outs[1] == 1.0 and outs[0] == pytest.approx(0.95)


def test_unsaved_masker_history_changes_a_resumed_mask():
    """The masker's temporal median and flow state are not saved: a fresh
    masker after a resume gives frame k another mask than the masker that
    saw frames 0..k-1 (here the flow of a moving block and the median
    vote)."""
    from lvdgs_torch.perception.masking import DynamicObjectMasker

    rng = np.random.default_rng(3)
    base = rng.uniform(0.2, 0.8, size=(3, 48, 64)).astype(np.float32)
    frames = []
    for i in range(5):
        img = base.copy()
        img[:, 20:34, 8 + 4 * i:24 + 4 * i] = 0.95  # a bright block moving right
        frames.append(img)
    run = DynamicObjectMasker(use_flow=True)
    masks = [run.get_static_mask(f, frame_idx=i) for i, f in enumerate(frames)]
    resumed = DynamicObjectMasker(use_flow=True).get_static_mask(frames[4], frame_idx=4)
    assert (masks[4] != resumed).any()


def test_unsaved_cams_leave_a_resumed_prior_without_its_keyframe(tmp_path):
    """`_cams` (the cameras of the window's keyframes) is not saved: with
    the MASt3R priors, the frame after a resume gets no last keyframe
    camera, so the fused depth prior runs its plain pair forward and the
    pose prior gives no seed (tracking falls back to Training.pose_seed),
    until the next keyframe; the unbroken run hands both priors the
    keyframe. Recording priors that change nothing show it."""
    cfg = _small_slam_config(5)
    cfg["Results"]["color_refinement"] = False

    def recording(log):
        def depth_prior(image, last_kf_cam=None):
            log.append(("depth", None if last_kf_cam is None else last_kf_cam.uid))
            return np.zeros(tuple(image.shape[1:]), np.float32)

        def pose_prior(cam, last_kf_cam, slam):
            log.append(("pose", None if last_kf_cam is None else last_kf_cam.uid))
            return None

        depth_prior.wants_kf = True
        return dict(depth_prior=depth_prior, pose_prior=pose_prior)

    whole, resumed_log = [], []
    run = SLAM(copy.deepcopy(cfg), device="cpu", **recording(whole))
    for i in range(3):
        run.process_frame(i)
    path = str(tmp_path / "ck")
    run.save_state(path)
    kf = run.current_window[0]
    run.process_frame(3)
    resumed = SLAM(copy.deepcopy(cfg), device="cpu", **recording(resumed_log))
    resumed.load_state(path)
    assert resumed.current_window[0] == kf and resumed._cams == {}
    resumed.process_frame(3)
    assert whole[-2:] == [("depth", kf), ("pose", kf)]
    assert resumed_log == [("depth", None), ("pose", None)]
