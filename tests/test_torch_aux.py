"""The port's auxiliary subsystems: the GUI feed (lvdgs_torch/gui), the
evaluation panels (lvdgs_torch/eval/viz.py, eval_rendering's dumps) and
DINOv2; copies of tests/test_aux.py's tests of them, on the port, with the
same files written as the reference writes for the same inputs."""
import importlib.util
import os
from pathlib import Path

import numpy as np
import torch

import tests.torch_parity  # noqa: F401  (one thread, no TF32)

ROOT = Path(__file__).resolve().parent.parent


def _map(capacity=128, n=10):
    from lvdgs_torch.gaussian import model as gm

    gmap = gm.create_map(capacity, "cpu")
    active = gmap.active.clone()
    active[:n] = True
    return gmap.replace(active=active)


def test_gui_packet_and_headless_viewer(tmp_path):
    from lvdgs_torch.gui.gui_utils import FakeQueue, GaussianPacket, HeadlessViewer, snapshot_gaussians

    snap = snapshot_gaussians(_map())
    assert snap["means"].shape == (10, 3) and isinstance(snap["means"], np.ndarray)
    assert {k: v.shape[0] for k, v in snap.items()} == dict.fromkeys(
        ("means", "colors", "opacities", "scales", "quats"), 10)

    v = HeadlessViewer(str(tmp_path), every=1)
    rng = np.random.default_rng(0)
    v.put(GaussianPacket(gaussians=snap, render=rng.uniform(0, 1, (3, 32, 32))))
    v.close()
    assert os.path.exists(os.path.join(str(tmp_path), "live_map.ply"))

    fq = FakeQueue()
    fq.put("x")
    assert fq.empty()


def _replay_viewer():
    spec = importlib.util.spec_from_file_location("replay_viewer", ROOT / "tools" / "replay_viewer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replay_viewer_composite(tmp_path):
    """The port's feed on disk (trajectory.jsonl, renders, the map PLY) is
    what the unchanged tools/replay_viewer.py composes; its files are the
    reference viewer's, byte for byte, for the same packets."""
    from lvdgs_torch.gui.gui_utils import GaussianPacket, HeadlessViewer, snapshot_gaussians
    from lvdgs_tpu.gui import gui_utils as jg

    gmap = _map()
    for tag, viewer, packet in (("ours", HeadlessViewer, GaussianPacket),
                                ("ref", jg.HeadlessViewer, jg.GaussianPacket)):
        out = tmp_path / tag
        v = viewer(str(out), every=1)
        rng = np.random.default_rng(0)
        for i in range(3):
            v.put(packet(
                gaussians=snapshot_gaussians(gmap) if i == 2 else None,
                render=rng.uniform(0, 1, (3, 32, 32)),
                current_frame={"R": np.eye(3), "T": np.array([0.1 * i, 0, 0]), "uid": i},
                keyframes=[{"R": np.eye(3), "T": np.zeros(3), "uid": 0}],
                kf_window={0: []},
            ))
        v.close()
    ours = sorted(os.listdir(tmp_path / "ours"))
    assert ours == sorted(os.listdir(tmp_path / "ref"))
    for name in ours:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name
    traj = tmp_path / "ours" / "trajectory.jsonl"
    assert len(traj.read_text().strip().splitlines()) == 3
    out = str(tmp_path / "replay.png")
    assert _replay_viewer().compose(str(tmp_path / "ours"), out) == 3 and os.path.exists(out)


def test_viz_outputs(tmp_path):
    from lvdgs_torch.eval.viz import mask_overlay, save_depth_comparison, six_panel

    rng = np.random.default_rng(1)
    d = rng.uniform(1, 5, (24, 32)).astype(np.float32)
    rgb = rng.uniform(0, 1, (3, 24, 32)).astype(np.float32)
    p1 = save_depth_comparison(d, d * 1.1, rgb, 3, str(tmp_path))
    assert os.path.exists(p1)
    # tensors too, as the SLAM hands them over
    p1t = save_depth_comparison(torch.as_tensor(d)[None], torch.as_tensor(d * 1.1), torch.as_tensor(rgb), 4,
                                str(tmp_path))
    p2 = six_panel(torch.as_tensor(rgb), rgb, torch.as_tensor(d), d, torch.as_tensor(d > 2), 4, str(tmp_path))
    assert os.path.exists(p1t) and os.path.exists(p2)
    assert sorted(os.listdir(tmp_path)) == ["3.png", "4.png", "panel_00004.png"]
    out = mask_overlay((rgb.transpose(1, 2, 0) * 255).astype(np.uint8), torch.as_tensor(d > 3))
    assert out.shape == (24, 32, 3)
    # PIL draws both figures, each panel under its title; no static mask
    # draws a white one
    from PIL import Image

    from lvdgs_torch.eval import viz

    p3 = six_panel(rgb, rgb, d, d, None, 5, str(tmp_path))
    for p in (p1, p2, p3):
        im = np.asarray(Image.open(p))
        assert im.ndim == 3 and im.shape[0] > 24 and im.std() > 0
    np.testing.assert_array_equal(viz._to_rgb(np.array([[0.0, 1.0]]), "viridis"), [[[68, 1, 84], [253, 231, 37]]])
    from lvdgs_tpu.eval.viz import mask_overlay as jmask

    img = (rgb.transpose(1, 2, 0) * 255).astype(np.uint8)
    np.testing.assert_array_equal(mask_overlay(img, d > 3, d > 2), jmask(img, d > 3, d > 2))


def test_eval_rendering_writes_viz(tmp_path):
    """eval_rendering with a save_dir writes the reference's per-frame
    files, render PNG and depth dump and the six-panel figure, under the
    reference's names for the same map, frames and dataset; with viz_every
    2 only the even frames."""
    import jax.numpy as jnp

    from lvdgs_torch.core.camera import Intrinsics
    from lvdgs_torch.eval.rendering import eval_rendering
    from lvdgs_torch.gaussian import model as gm
    from lvdgs_torch.ops.rasterizer import RenderConfig
    from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
    from lvdgs_tpu.eval.rendering import eval_rendering as jeval
    from lvdgs_tpu.gaussian import model as jgm
    from lvdgs_tpu.ops.rasterizer import RenderConfig as JRenderConfig

    rng = np.random.default_rng(0)
    n = 64
    means = (rng.normal(0, 1, (n, 3)) + np.array([0, 0, 4.0])).astype(np.float32)
    imgs = [rng.uniform(0, 1, (3, 24, 32)).astype(np.float32) for _ in range(4)]
    monos = [rng.uniform(1, 5, (24, 32)).astype(np.float32) for _ in range(4)]

    class FakeDS:
        def __init__(self, conv):
            self.conv = conv

        def __len__(self):
            return 4

        def __getitem__(self, i):
            return self.conv(imgs[i]), None, None, self.conv(monos[i])

    frames = {i: {"R": np.eye(3, dtype=np.float32), "T": np.zeros(3, np.float32),
                  "static_mask": np.ones((24, 32), bool)} for i in range(4)}

    gmap = gm.create_map(256, "cpu")
    gmap.means[:n] = torch.as_tensor(means)
    gmap.active[:n] = True
    jmap = jgm.create_map(256)
    jmap = jmap.replace(means=jmap.means.at[:n].set(jnp.asarray(means)), active=jmap.active.at[:n].set(True))
    intr = dict(fx=30.0, fy=30.0, cx=16.0, cy=12.0, width=32, height=24)

    res = eval_rendering(gmap, frames, FakeDS(torch.as_tensor), Intrinsics(**intr),
                         RenderConfig(tile_size=16, max_per_tile=64), save_dir=str(tmp_path / "ours"),
                         kf_indices=[0], iteration="test")
    ref = jeval(jmap, frames, FakeDS(jnp.asarray), JIntrinsics(**intr),
                JRenderConfig(tile_size=16, max_per_tile=64, use_pallas=True, use_packed=False),
                save_dir=str(tmp_path / "ref"), kf_indices=[0], iteration="test")
    assert res["n_eval_frames"] == ref["n_eval_frames"] == 3
    assert len(os.listdir(tmp_path / "ours" / "panels_test")) == 3  # one per evaluated frame

    def listing(root):
        return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*"))

    assert listing(tmp_path / "ours") == listing(tmp_path / "ref")
    for i in (1, 2, 3):
        d_ours = np.load(tmp_path / "ours" / "renders_test" / f"depth_{i:05d}.npy")
        d_ref = np.load(tmp_path / "ref" / "renders_test" / f"depth_{i:05d}.npy")
        np.testing.assert_allclose(d_ours, d_ref, atol=3e-3)  # the depth tolerance of the port's renders

    eval_rendering(gmap, frames, FakeDS(torch.as_tensor), Intrinsics(**intr),
                   RenderConfig(tile_size=16, max_per_tile=64), save_dir=str(tmp_path / "even"),
                   kf_indices=[0], iteration="test", viz_every=2)
    assert sorted(os.listdir(tmp_path / "even" / "panels_test")) == ["panel_00002.png"]
    eval_rendering(gmap, frames, FakeDS(torch.as_tensor), Intrinsics(**intr),
                   RenderConfig(tile_size=16, max_per_tile=64), save_dir=str(tmp_path / "none"),
                   kf_indices=[0], iteration="test", viz_every=0)
    assert sorted(os.listdir(tmp_path / "none")) == ["metrics_test.json"]


def test_dinov2_forward_tiny():
    from lvdgs_torch.models.dinov2.model import TINY_DINO, dinov2_forward, init_params

    cfg = TINY_DINO
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = dinov2_forward(model, torch.zeros((1, 3, 32, 40)))
    assert len(out["tokens"]) == cfg.depth
    assert out["final"].shape == (1, 1 + 4 * 5, cfg.dim)
    assert out["attn"][0].shape == (1, cfg.heads, 21, 21)
