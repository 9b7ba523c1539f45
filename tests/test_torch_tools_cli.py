"""The port's tool scripts (python -m lvdgs_torch.tools.<name>), each run once
on the CPU at a tiny size, or with --help where it needs weights the repo
lacks: gen_prompt_vocab writes the packaged vocab byte for byte,
colmap_export exports a tiny saved state (with oracle keyframe matches),
batch_detect and semantic_label run model-free on two small images,
dinov2_analyze runs ViT-B/14 with random weights on a 56x56 input, and
sam_setup reports a missing checkpoint."""
import copy
import json
import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

ROOT = Path(__file__).resolve().parent.parent


def _run(*args, ok=True, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "LVDGS_MAST3R_CKPT"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if ok:
        assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_gen_prompt_vocab_writes_the_packaged_vocab(tmp_path):
    from lvdgs_torch.models.groundingdino import inference

    out = tmp_path / "prompt_vocab.txt"
    _run("lvdgs_torch.tools.gen_prompt_vocab", "--out", str(out))
    assert out.read_bytes() == Path(inference._PACKAGED_VOCAB).read_bytes()
    from lvdgs_torch.tools import gen_prompt_vocab

    assert Path(gen_prompt_vocab.OUT).resolve() == Path(inference._PACKAGED_VOCAB).resolve()


def test_colmap_export_on_a_tiny_saved_state(tmp_path):
    """A 5-frame run of the small config on the CPU, saved; the tool loads
    it into a fresh SLAM and exports, matching consecutive keyframes
    through the oracle: one camera, one image per frame, matches for each
    keyframe pair, a point per active Gaussian."""
    from lvdgs_torch.slam.system import SLAM
    from tests.test_torch_slam import _small_slam_config

    cfg = _small_slam_config(5)
    slam = SLAM(copy.deepcopy(cfg), save_dir=None, device="cpu")
    slam.run(progress=False)
    assert len(slam.kf_indices) >= 2
    state = str(tmp_path / "state.pt")
    slam.save_state(state)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "colmap"
    _run("lvdgs_torch.tools.colmap_export", "--config", str(cfg_path), "--checkpoint", state, "--out", str(out),
         "--match-keyframes", "--device", "cpu")
    conn = sqlite3.connect(out / "database.db")
    assert conn.execute("SELECT COUNT(*) FROM cameras").fetchone()[0] == 1
    assert conn.execute("SELECT COUNT(*) FROM images").fetchone()[0] == 5
    assert conn.execute("SELECT COUNT(*) FROM matches").fetchone()[0] == len(slam.kf_indices) - 1
    assert min(r for (r,) in conn.execute("SELECT rows FROM matches")) > 0
    conn.close()
    pts = [ln for ln in (out / "sparse" / "points3D.txt").read_text().splitlines() if not ln.startswith("#")]
    assert len(pts) == slam.gmap.num_active


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(2):
        img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        img[30:, :] = [100, 95, 90]
        Image.fromarray(img).save(d / f"frame_{i}.png")
    return d


def test_batch_detect_model_free(tmp_path, images):
    _run("lvdgs_torch.tools.batch_detect", "--input", str(images), "--output", str(tmp_path), "--device", "cpu")
    report = json.loads((tmp_path / "batch_report.json").read_text())
    assert report["n_images"] == 2
    for sub in ("overlay", "mask", "grid", "contour", "compare", "json"):
        assert len(os.listdir(tmp_path / sub)) == 2, sub


def test_semantic_label_without_a_detector(tmp_path, images):
    _run("lvdgs_torch.tools.semantic_label", "--input", str(images), "--output", str(tmp_path), "--device", "cpu")
    report = json.loads((tmp_path / "label_report.json").read_text())
    assert len(report["images"]) == 2 and report["mean_labeled_ratio"] == 0.0
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"frame_{i}{s}" for i in range(2) for s in ("_ids.png", "_colored.png", ".json")] + ["label_report.json"])


def test_dinov2_analyze_random_weights(tmp_path, images):
    _run("lvdgs_torch.tools.dinov2_analyze", "--image", str(images / "frame_0.png"), "--output", str(tmp_path),
         "--side", "56", "--layers", "0", "11", "--device", "cpu")
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert [s["layer"] for s in stats] == [0, 11]
    assert all(np.isfinite(s["attn_entropy"]) for s in stats)
    assert (tmp_path / "layer11_pca.png").exists() and (tmp_path / "feature_evolution.png").exists()


def test_sam_setup_reports_a_missing_checkpoint(tmp_path):
    out = _run("lvdgs_torch.tools.sam_setup", "--checkpoint", str(tmp_path / "none.pth"), "--device", "cpu",
               ok=False)
    assert out.returncode == 1 and "not found" in out.stdout
    assert "--checkpoint" in _run("lvdgs_torch.tools.sam_setup", "--help").stdout


def test_every_tool_has_help():
    for name in ("colmap_export", "batch_detect", "semantic_label", "dinov2_analyze", "gen_prompt_vocab"):
        assert "--device" in _run(f"lvdgs_torch.tools.{name}", "--help").stdout or name == "gen_prompt_vocab"
