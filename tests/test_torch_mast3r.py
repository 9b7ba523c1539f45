"""MASt3R of lvdgs_torch (models/mast3r: vit, dpt, model, matching,
inference, oracle; convert.mast3r_state_dict_from_numpy) against
lvdgs_tpu on the CPU, and the SLAM's prior plug points.

Port copies of tests/test_mast3r.py and tests/test_oracle_prior.py, each
also held against the reference on the same NumPy inputs. The network is
compared at the TINY config with the reference's random parameters carried
over by the converter; float32 both sides, the outputs within 2e-5 of each
field's largest magnitude (the reference's own fused-forward tolerance,
tests/test_mast3r.py, taken relative: random-weight pointmaps are tiny).
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.core.config import load_config as jload_config
from lvdgs_tpu.data.datasets import load_dataset as jload_dataset
from lvdgs_tpu.gaussian import model as jgm
from lvdgs_tpu.models.mast3r import inference as jinf
from lvdgs_tpu.models.mast3r import model as jm
from lvdgs_tpu.models.mast3r import vit as jvit
from lvdgs_tpu.models.mast3r.convert import convert_state_dict
from lvdgs_tpu.models.mast3r.matching import fast_reciprocal_nns as jnns
from lvdgs_tpu.models.mast3r.oracle import OracleMASt3R as JOracle
from lvdgs_tpu.ops import rasterizer as jr
from lvdgs_torch import convert
from lvdgs_torch.core.config import load_config
from lvdgs_torch.data.datasets import load_dataset
from lvdgs_torch.models.mast3r import inference as tinf
from lvdgs_torch.models.mast3r import model as tm
from lvdgs_torch.models.mast3r import vit as tvit
from lvdgs_torch.models.mast3r.matching import fast_reciprocal_nns as tnns
from lvdgs_torch.models.mast3r.oracle import OracleMASt3R
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.slam.system import SLAM
from test_torch_slam import _small_slam_config
from torch_parity import camera_pair, map_to_torch, to_np

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "mono", "synthetic", "base_config.yaml")
TOL = 2e-5
KEYS = ("pts3d", "conf", "desc", "desc_conf")


def _assert_rel_close(a, b, tol=TOL, what=""):
    a, b = to_np(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol * max(float(np.abs(b).max()), 1e-30), (what, err, float(np.abs(b).max()))


def _assert_preds_close(t_preds, j_preds, tol=TOL):
    for i, (t, j) in enumerate(zip(t_preds, j_preds)):
        for k in KEYS:
            _assert_rel_close(t[k], j[k], tol, f"pred {i} {k}")


@pytest.fixture(scope="module")
def tiny():
    """The reference's TINY random parameters and the port's module holding
    them (through convert.mast3r_state_dict_from_numpy, loaded strictly)."""
    params = jm.init_params(jax.random.PRNGKey(0), jm.TINY)
    model = tm.MASt3R(tm.TINY)
    model.load_state_dict(convert.mast3r_state_dict_from_numpy(jax.tree.map(np.asarray, params), tm.TINY),
                          strict=True)
    return params, model.eval()


def _imgs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


# ---------------------------------------------------------------------------
# the network


def test_forward_shapes_tiny():
    """Port copy of tests/test_mast3r.py::test_forward_shapes_tiny, with the
    port's own init from a torch.Generator."""
    cfg = tm.TINY
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    H, W = 64, 96
    a, b = (torch.tensor(x) for x in _imgs(0, (1, 3, H, W)))
    pred1, pred2 = tm.mast3r_forward(model, a, b)
    for pred in (pred1, pred2):
        assert pred["pts3d"].shape == (1, H, W, 3)
        assert pred["conf"].shape == (1, H, W)
        assert pred["desc"].shape == (1, H, W, cfg.local_feat_dim)
        assert pred["desc_conf"].shape == (1, H, W)
        assert float(pred["conf"].min()) >= cfg.conf_vmin
        np.testing.assert_allclose(to_np(torch.linalg.norm(pred["desc"], dim=-1)), 1.0, atol=1e-5)
    assert np.all(np.isfinite(to_np(pred1["pts3d"])))
    assert float((pred1["desc"] - pred2["desc"]).abs().max()) > 1e-6  # asymmetric heads
    # the reference's distributions: patch embedding std 0.02, linears
    # 0.25 sqrt(2 / (din + dout)), zero biases, unit norms
    w = model.patch_embed.proj.weight
    assert abs(float(w.std()) - 0.02) < 0.002
    lin = model.enc_blocks[0].mlp.fc1
    want = 0.25 * (2.0 / sum(lin.weight.shape)) ** 0.5
    assert abs(float(lin.weight.std()) / want - 1.0) < 0.05
    assert float(lin.bias.abs().max()) == 0.0 and float(model.enc_norm.weight.min()) == 1.0


@pytest.mark.parametrize("hw", [(64, 96), (144, 176)], ids=["even-grid", "odd-grid"])
def test_forward_matches_reference(tiny, hw):
    """TINY forward against the reference on the same parameters and
    images; the 9-row grid resizes the DPT's 10-row path to 9 (the
    reference's antialiased jax.image.resize)."""
    params, model = tiny
    a, b = _imgs(1, (1, 3) + hw)
    j1, j2 = jm.mast3r_forward(params, jnp.asarray(a), jnp.asarray(b), jm.TINY)
    t1, t2 = tm.mast3r_forward(model, torch.tensor(a), torch.tensor(b))
    _assert_preds_close((t1, t2), (j1, j2))


@pytest.mark.parametrize("hw2", [(64, 96), (144, 176)], ids=["equal-shape", "two-shape"])
def test_separate_encoding_matches_reference(tiny, hw2):
    """The forward that encodes each view alone (coarse-to-fine crop pairs
    of two shapes) against the reference's own encoder, decoder and heads
    composed the same way at each view's grid; at equal shapes also against
    the batched forward, the port's and the reference's."""
    params, model = tiny
    a, _ = _imgs(3, (1, 3, 64, 96))
    _, b = _imgs(4, (1, 3) + hw2)
    with torch.no_grad():
        apart = tm._forward_apart(model, torch.tensor(a), torch.tensor(b))
    ps = jm.TINY.patch_size
    f1, pos1 = jm._encode(jnp.asarray(a), params, jm.TINY)
    f2, pos2 = jm._encode(jnp.asarray(b), params, jm.TINY)
    o1, o2 = jm._decode(f1, pos1, f2, pos2, params, jm.TINY)
    composed = (jm._head(o1, (64 // ps, 96 // ps), params["head1"], jm.TINY),
                jm._head(o2, (hw2[0] // ps, hw2[1] // ps), params["head2"], jm.TINY))
    _assert_preds_close(apart, composed)
    assert apart[1]["desc"].shape[1:3] == hw2
    if hw2 == (64, 96):
        _assert_preds_close(apart, tm.mast3r_forward(model, torch.tensor(a), torch.tensor(b)))
        _assert_preds_close(apart, jm.mast3r_forward(params, jnp.asarray(a), jnp.asarray(b), jm.TINY))
    else:
        _assert_preds_close(apart, tm.mast3r_forward(model, torch.tensor(a), torch.tensor(b)), 0.0)


def test_fused_forward_matches_reference_and_two_calls(tiny):
    """Port copy of tests/test_mast3r.py::test_fused_forward_matches_two_calls,
    and the fused forward against the reference's."""
    params, model = tiny
    kf, cur = _imgs(2, (1, 3, 32, 48))
    pose1, pose2, depth1 = tm.mast3r_forward_fused(model, torch.tensor(kf), torch.tensor(cur))
    ref_p1, ref_p2 = tm.mast3r_forward(model, torch.tensor(kf), torch.tensor(cur))
    ref_d1, _ = tm.mast3r_forward(model, torch.tensor(cur), torch.tensor(cur))
    for k in KEYS:
        for got, want in ((pose1, ref_p1), (pose2, ref_p2), (depth1, ref_d1)):
            _assert_rel_close(got[k], to_np(want[k]), TOL, k)
    j = jm.mast3r_forward_fused(params, jnp.asarray(kf), jnp.asarray(cur), jm.TINY)
    _assert_preds_close((pose1, pose2, depth1), j)


def test_rope_matches_reference_and_keeps_norm_and_relativity():
    """Port copy of tests/test_mast3r.py::test_rope_preserves_norm_and_relativity,
    and the rotation against the reference's."""
    d = 16
    pos = torch.tensor([[3, 7], [0, 0], [5, 2]])
    cos, sin = tvit.rope2d_angles(pos, d)
    jcos, jsin = jvit.rope2d_angles(jnp.asarray(pos.numpy()), d)
    np.testing.assert_allclose(to_np(cos), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(to_np(sin), np.asarray(jsin), atol=1e-6)
    g = torch.Generator().manual_seed(1)
    q, k = torch.randn((1, 2, 3, d), generator=g), torch.randn((1, 2, 3, d), generator=g)
    q_rot = tvit.apply_rope2d(q, cos, sin)
    np.testing.assert_allclose(to_np(q_rot), np.asarray(jvit.apply_rope2d(jnp.asarray(q.numpy()), jcos, jsin)),
                               atol=1e-6)
    np.testing.assert_allclose(to_np(q_rot.norm(dim=-1)), to_np(q.norm(dim=-1)), rtol=1e-5)

    def dots(shift):
        c1, s1 = tvit.rope2d_angles(pos + torch.tensor(shift), d)
        return (tvit.apply_rope2d(q, c1, s1) * tvit.apply_rope2d(k, c1, s1)).sum(-1)

    np.testing.assert_allclose(to_np(dots([0, 0])), to_np(dots([11, 4])), rtol=1e-4, atol=1e-6)


def test_pixel_shuffle_matches_reference():
    """Port copy of tests/test_mast3r.py::test_pixel_shuffle_matches_torch_semantics:
    the head's F.pixel_shuffle against the reference's _pixel_shuffle."""
    x = np.random.default_rng(6).normal(size=(2, 8 * 4, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(to_np(torch.nn.functional.pixel_shuffle(torch.tensor(x), 2)),
                                  np.asarray(jm._pixel_shuffle(jnp.asarray(x), 2)))


def _checkpoint(tmp_path, sd, extra=None):
    """A file laid out as the official one: the state_dict under "model"
    (with the DPT scratch's layer_rn aliases) and an argparse.Namespace
    under "args"."""
    model_sd = dict(sd)
    for h in (1, 2):
        for i in range(4):
            model_sd[f"downstream_head{h}.dpt.scratch.layer_rn.{i}.weight"] = \
                sd[f"downstream_head{h}.dpt.scratch.layer{i + 1}_rn.weight"]
    model_sd.update(extra or {})
    path = str(tmp_path / "mast3r.pth")
    torch.save({"model": model_sd, "args": argparse.Namespace(model="AsymmetricMASt3R(...)", seed=0)}, path)
    return path


def test_official_state_dict_loads_in_both_packages(tmp_path):
    """Port copy of tests/test_mast3r.py::test_convert_roundtrip_tiny: a
    random state_dict under the official names (the port's init, saved as
    the official file is) goes through the reference's convert_state_dict
    and the port's strict load (MASt3RInference.from_checkpoint, with
    weights_only=True); both give the same outputs. The converter's
    inverse gives back the same state_dict; a key that names no parameter
    is refused."""
    model = tm.init_params(tm.TINY, torch.Generator().manual_seed(7))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    path = _checkpoint(tmp_path, sd)
    loaded = tinf.MASt3RInference.from_checkpoint(path, tm.TINY, device="cpu")
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    params = convert_state_dict(torch.load(path, weights_only=False)["model"], jm.TINY)
    back = convert.mast3r_state_dict_from_numpy(jax.tree.map(np.asarray, params), tm.TINY)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    img = _imgs(8, (1, 3, 32, 48))[0]
    t1, t2 = tm.mast3r_forward(loaded.model, torch.tensor(img), torch.tensor(img))
    j1, j2 = jm.mast3r_forward(params, jnp.asarray(img), jnp.asarray(img), jm.TINY)
    _assert_preds_close((t1, t2), (j1, j2))
    bad = _checkpoint(tmp_path, sd, extra={"enc_pos_embed": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="enc_pos_embed"):
        tinf.load_checkpoint(bad, tm.TINY, device="cpu")


# ---------------------------------------------------------------------------
# matching and preprocessing


def test_matching_identity_descriptors():
    """Port copy of tests/test_mast3r.py::test_matching_identity_descriptors;
    the matches equal the reference's."""
    rng = np.random.default_rng(3)
    desc = rng.normal(size=(32, 48, 8)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    m1, m2 = tnns(desc, desc, subsample=8)
    assert len(m1) > 10
    np.testing.assert_array_equal(m1, m2)
    for a, b in zip((m1, m2), jnns(desc, desc, subsample=8)):
        np.testing.assert_array_equal(a, b)


def test_matching_shifted_descriptors():
    """Port copy of tests/test_mast3r.py::test_matching_shifted_descriptors,
    with a small block so the blocked search carries its best across
    blocks; the matches equal the reference's."""
    rng = np.random.default_rng(4)
    base = rng.normal(size=(32, 64, 8)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    d2 = np.roll(base, 5, axis=1)
    for block in (2**13, 300):
        m1, m2 = tnns(base, torch.tensor(d2), subsample=8, block=block)
        assert len(m1) > 5
        assert np.mean((m2[:, 0] - m1[:, 0]) % 64 == 5) > 0.8
        for a, b in zip((m1, m2), jnns(base, d2, subsample=8, block=block)):
            np.testing.assert_array_equal(a, b)


def test_preprocess_image_matches_reference():
    """Port copy of tests/test_mast3r.py::test_preprocess_image_shape_alignment
    (the street's 1226x370 frame), equal to the reference's bit for bit."""
    img = np.random.default_rng(5).uniform(0, 1, size=(3, 370, 1226)).astype(np.float32)
    out, (H, W) = tinf.preprocess_image(torch.tensor(img), 512)
    assert out.shape == (3, H, W) == (3, 144, 512)
    assert out.min() >= -1.0 - 1e-6 and out.max() <= 1.0 + 1e-6
    ref, shape = jinf.preprocess_image(img, 512)
    assert shape == (H, W)
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# the priors


def test_fused_priors_cache_flow():
    """Port copy of tests/test_mast3r.py::test_fused_priors_cache_flow: the
    depth prior without a keyframe runs one pair forward; with one, the
    fused forward, whose pose pair the pose prior then takes from the
    cache without a forward of its own."""
    from lvdgs_torch.core.camera import Intrinsics

    model = tinf.MASt3RInference(tm.init_params(tm.TINY, torch.Generator().manual_seed(0)), size=48)
    calls = {"fused": 0, "pair": 0}
    orig_fused, orig_pair = model.infer_fused, model.infer_pair

    def counting_fused(a, b):
        calls["fused"] += 1
        return orig_fused(a, b)

    def counting_pair(a, b):
        calls["pair"] += 1
        return orig_pair(a, b)

    model.infer_fused, model.infer_pair = counting_fused, counting_pair
    intr = Intrinsics(40.0, 40.0, 24.0, 16.0, 48, 32)
    depth_prior, pose_prior = tinf.make_fused_priors(model, intr)
    assert getattr(depth_prior, "wants_kf", False)
    img = torch.tensor(np.random.default_rng(0).random((3, 32, 48), np.float32))

    class FakeCam:
        uid = 7
        image = img
        R = torch.eye(3)
        T = torch.zeros(3)

    d0 = depth_prior(img)
    assert d0.shape == (32, 48) and np.isfinite(d0).all()
    assert calls == {"fused": 0, "pair": 1}
    d1 = depth_prior(img, last_kf_cam=FakeCam())
    assert d1.shape == (32, 48) and np.isfinite(d1).all()
    assert calls == {"fused": 1, "pair": 1}

    class FakeSlam:
        gmap = map_to_torch(jgm.create_map(64))
        rcfg = tr.RenderConfig(max_per_tile=64, tile_chunk=16)
        frames = {6: {"R": np.eye(3), "T": np.ones(3)}}

    cam = FakeCam()
    cam.uid = 7
    R, T = pose_prior(cam, FakeCam(), FakeSlam())
    # random descriptors give too few matches: identity PnP -> the previous
    # frame's pose, with no forward of its own
    np.testing.assert_array_equal(T, np.ones(3))
    assert calls == {"fused": 1, "pair": 1}


def _street_config(load, n_frames=20):
    """tests/test_oracle_prior.py's street config."""
    config = load(CFG_PATH)
    config["Dataset"].update({
        "scene": "street", "n_frames": n_frames, "step": 0.5, "accel_frames": 4,
        "street_half_width": 8.0, "street_spacing": 0.5, "photo_gain_jitter": 0.0,
        "photo_bias_jitter": 0.0, "photo_noise": 0.0, "mono_scale_error": 1.0, "mono_noise": 0.0,
        "pcd_downsample": 16, "pcd_downsample_init": 8,
    })
    config["Dataset"]["Calibration"].update({"width": 160, "height": 48, "fx": 95.0, "fy": 95.0,
                                             "cx": 80.0, "cy": 24.0})
    config["Training"].update({
        "pose_seed": "constant_velocity", "init_itr_num": 300, "mapping_itr_num": 30,
        "mapping_itr_nosingle": 10, "tracking_itr_num": 40, "kf_interval": 3, "window_size": 6,
        "single_thread": False,
    })
    config["Results"].update({"save_results": False, "eval_rendering": False, "color_refinement": False})
    config["Performance"] = {"tile_size": 16, "max_per_tile": 128, "gaussian_chunk": 16, "tile_chunk": 32,
                             "map_capacity": 16384, "kf_capacity": 32}
    return config


@pytest.fixture(scope="module")
def streets():
    """The small street's dataset in both packages, and an oracle on each."""
    jds = jload_dataset(None, "", _street_config(jload_config, 6))
    tds = load_dataset(None, "", _street_config(load_config, 6), "cpu")
    return (jds, JOracle(jds, jds.intrinsics)), (tds, OracleMASt3R(tds, tds.intrinsics))


def test_oracle_descriptors_match_true_correspondences(streets):
    """Port copy of tests/test_oracle_prior.py::test_oracle_descriptors_match_true_correspondences:
    reciprocal matching of the oracle's descriptors recovers true
    cross-view correspondences; the matches equal the reference's."""
    (jds, joracle), (tds, oracle) = streets
    p1, p2, (H, W) = oracle.infer_pair(tds[0][0], tds[4][0])
    m1, m2 = tnns(p1["desc"][0], p2["desc"][0])
    assert len(m1) >= 20, len(m1)
    _, w0 = oracle._frame_geometry(0)
    _, w4 = oracle._frame_geometry(4)
    err = np.linalg.norm(w0[m1[:, 1], m1[:, 0]] - w4[m2[:, 1], m2[:, 0]], axis=1)
    assert np.median(err) < 0.35, np.median(err)
    assert (err < 0.5).mean() > 0.6, (err < 0.5).mean()
    jp1, jp2, _ = joracle.infer_pair(np.asarray(jds[0][0]), np.asarray(jds[4][0]))
    # world points from two renders of the street, equal to float32 rounding
    _assert_rel_close(p1["desc"], jp1["desc"], 1e-4)
    for a, b in zip((m1, m2), jnns(jp1["desc"][0], jp2["desc"][0])):
        np.testing.assert_array_equal(a, b)


def test_fused_priors_match_reference_on_the_street(streets):
    """make_fused_priors over the oracle (depth_scale 0.9) in both packages,
    on the small street with a map seeded from frame 0's depth and the
    keyframe at frame 0: each later frame's mono depth within 3e-3 of the
    reference's and its pose seed within 1e-3 (matching, the median-depth
    render of the map, PnP-RANSAC, the seed's composition); PnP succeeds."""
    (jds, _), (tds, _) = streets
    intr_j, intr_t = jds.intrinsics, tds.intrinsics
    jdp, jpp = jinf.make_fused_priors(JOracle(jds, intr_j, depth_scale=0.9), intr_j)
    tdp, tpp = tinf.make_fused_priors(OracleMASt3R(tds, intr_t, depth_scale=0.9), intr_t)
    img0, depth0, pose0, _ = jds[0]
    kf_j = JCamera.create(0, jnp.asarray(img0), intr_j).update_RT(jnp.asarray(pose0[:3, :3]),
                                                                  jnp.asarray(pose0[:3, 3]))
    kf_t = camera_pair(kf_j)[1].replace(image=tds[0][0])  # each oracle knows its own frames
    jmap = jgm.seed_from_depth(jgm.create_map(8192), kf_j, jnp.asarray(depth0), intr_j, kf_id=0, downsample=2)
    rcfg_j = jr.RenderConfig(tile_size=16, max_per_tile=128, gaussian_chunk=16, tile_chunk=32)
    rcfg_t = tr.RenderConfig(max_per_tile=128, tile_chunk=32)

    class Slam:
        def __init__(self, gmap, rcfg):
            self.gmap, self.rcfg, self.frames = gmap, rcfg, {}

    js, ts = Slam(jmap, rcfg_j), Slam(map_to_torch(jmap), rcfg_t)
    pnp = {"ok": 0}
    pose_from_preds = tinf._pose_from_preds

    def counted(*a, **kw):
        pose, depth = pose_from_preds(*a, **kw)
        pnp["ok"] += int(not np.allclose(pose, np.eye(4), atol=1e-6))
        return pose, depth

    tinf._pose_from_preds = counted
    try:
        for i in range(1, 6):
            img_j, img_t = np.asarray(jds[i][0]), tds[i][0]
            dj, dt = jdp(img_j, last_kf_cam=kf_j), tdp(img_t, last_kf_cam=kf_t)
            _assert_rel_close(dt, dj, 3e-3, f"mono depth {i}")

            class Cam:
                uid = i
                image = img_t

            Rj, Tj = jpp(Cam, kf_j, js)
            Rt, Tt = tpp(Cam, kf_t, ts)
            np.testing.assert_allclose(np.asarray(Rt), np.asarray(Rj), atol=1e-3)
            np.testing.assert_allclose(np.asarray(Tt), np.asarray(Tj), atol=1e-3)
    finally:
        tinf._pose_from_preds = pose_from_preds
    assert pnp["ok"] == 5, pnp


def test_scale_remedy_matches_reference(streets):
    """make_scale_remedy over the oracle (depth_scale 0.9) in both packages:
    the matched-depth ratio of frame 0 (the keyframe, its GT depth scaled
    by 1.25 as its mono depth) over frame 4 (GT depth) at their reciprocal
    matches, within 1e-4 of the reference's."""
    (jds, _), (tds, _) = streets

    class Cam:
        def __init__(self, ds, i, scale):
            self.image, self.mono_depth = ds[i][0], ds[i][1] * scale

    j = jinf.make_scale_remedy(JOracle(jds, jds.intrinsics, depth_scale=0.9))(Cam(jds, 4, 1.0),
                                                                              Cam(jds, 0, 1.25))
    t = tinf.make_scale_remedy(OracleMASt3R(tds, tds.intrinsics, depth_scale=0.9))(Cam(tds, 4, 1.0),
                                                                                  Cam(tds, 0, 1.25))
    assert np.isfinite(j) and j > 1.0, j  # the keyframe's depths are scaled up
    assert t == pytest.approx(j, rel=1e-4)


def test_slam_prior_plug_points():
    """SLAM's pose_prior, depth_prior (wants_kf) and scale_remedy on the
    small CPU recipe: the depth prior is asked every frame, with the last
    keyframe's camera once there is one; the pose prior seeds every
    tracked frame (its seed is the pose tracking starts from); the scale
    remedy is asked at each keyframe's fusion when patch alignment finds
    too few accurate pixels (forced here by a ratio no frame can meet)."""
    cfg = _small_slam_config(6)
    cfg["Results"]["color_refinement"] = False
    cfg.setdefault("depth", {})["min_accurate_pixels_ratio"] = 2.0
    log = {"depth": [], "pose": [], "remedy": []}

    def depth_prior(image, last_kf_cam=None):
        log["depth"].append(None if last_kf_cam is None else last_kf_cam.uid)
        return np.full(tuple(image.shape[1:]), 4.0, np.float32)

    depth_prior.wants_kf = True

    def pose_prior(cam, last_kf_cam, slam):
        log["pose"].append((cam.uid, last_kf_cam.uid, slam.current_window[0]))
        return to_np(cam.R_gt), to_np(cam.T_gt)

    def scale_remedy(cam, last_kf_cam):
        log["remedy"].append((cam.uid, last_kf_cam.uid))
        return 1.0

    slam = SLAM(cfg, save_dir=None, device="cpu", pose_prior=pose_prior, depth_prior=depth_prior,
                scale_remedy=scale_remedy)
    seeds = []
    pose_seed = slam._pose_seed

    def recorded(idx, cam):
        cam = pose_seed(idx, cam)
        seeds.append(to_np(cam.T))
        return cam

    slam._pose_seed = recorded
    slam.run(progress=False)
    assert log["depth"][0] is None and len(log["depth"]) == 6
    assert all(uid is not None for uid in log["depth"][1:])
    assert [p[0] for p in log["pose"]] == [1, 2, 3, 4, 5]
    assert all(kf == w for _, kf, w in log["pose"])
    for i, seed in zip(range(1, 6), seeds):
        np.testing.assert_allclose(seed, slam.frames[i]["T_gt"], atol=1e-6)
    # mono depth is the prior's (4.0), rescaled by the fusion
    assert float(slam.kfbuf.mono_depth[0].max()) == 4.0
    assert len(log["remedy"]) == len(slam.kf_indices) - 1 > 0
    # the fusion asks with the new keyframe's own camera as the window's newest
    assert all(c == k for c, k in log["remedy"])


def test_cli_builds_the_fused_priors_from_a_checkpoint(tmp_path, monkeypatch):
    """python -m lvdgs_torch with mast3r.checkpoint naming a file that
    exists loads the network from it on the run's device and hands SLAM
    the fused depth and pose priors and the scale remedy; naming no file,
    it hands none. (The load is stubbed with a TINY network: no weights
    are in the repo.)"""
    import yaml

    from lvdgs_torch.__main__ import main

    loads = []

    def from_checkpoint(path, cfg=None, device=None):
        loads.append((path, str(device)))
        return tinf.MASt3RInference(tm.init_params(tm.TINY, torch.Generator().manual_seed(0)), size=64)

    built = []

    def run(self, **kw):
        built.append((self.depth_prior, self.pose_prior, self.scale_remedy))
        return {}

    monkeypatch.setattr(tinf.MASt3RInference, "from_checkpoint", staticmethod(from_checkpoint))
    monkeypatch.setattr(SLAM, "run", run)
    ckpt = tmp_path / "mast3r.pth"
    for exists in (True, False):
        if exists:
            ckpt.write_bytes(b"")
        elif ckpt.exists():
            ckpt.unlink()
        cfg = _small_slam_config(2)
        cfg["mast3r"] = {"checkpoint": str(ckpt)}
        cfg_path = str(tmp_path / "small.yaml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(cfg, fh)
        main(["--config", cfg_path, "--device", "cpu", "--save-dir", str(tmp_path / "out")])
    assert loads == [(str(ckpt), "cpu")]
    (depth, pose, remedy), none = built
    assert depth.wants_kf and callable(pose) and callable(remedy)
    assert none == (None, None, None)


@pytest.mark.slow
def test_fused_prior_path_beats_constant_velocity():
    """Port copy of tests/test_oracle_prior.py::test_fused_prior_path_beats_constant_velocity
    (slow, as there): the 20-frame street with make_fused_priors over the
    oracle must track to well under a metre and beat the no-prior run."""
    from lvdgs_torch.eval.ate import eval_ate

    def _run(with_prior: bool):
        config = _street_config(load_config)
        slam = SLAM(config, save_dir=None, device="cpu")
        if with_prior:
            oracle = OracleMASt3R(slam.dataset, slam.intr, depth_scale=0.9)
            slam.depth_prior, slam.pose_prior = tinf.make_fused_priors(oracle, slam.intr)
        for i in range(20):
            slam.process_frame(i)
        return float(eval_ate(slam.frames, slam.kf_indices, None, 0, final=True, monocular=True))

    ate_prior, ate_cv = _run(True), _run(False)
    assert np.isfinite(ate_prior)
    assert ate_prior < 0.5, (ate_prior, ate_cv)
    assert ate_prior <= ate_cv * 1.05, (ate_prior, ate_cv)
