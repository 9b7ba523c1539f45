"""The port's COLMAP export (lvdgs_torch/io/colmap.py): copies of
tests/test_colmap.py on the port, and the text model written from the same
NumPy frames and points byte for byte equal to the reference's."""
import sqlite3
import types

import numpy as np
import torch

from lvdgs_torch.io import colmap as tc
from lvdgs_tpu.io import colmap as jc
from tests.test_colmap import _rot


def test_qvec_roundtrip():
    for ang in (0.0, 0.3, -1.2, 2.9):
        R = _rot("z", ang) @ _rot("x", ang * 0.7)
        q = tc.rotmat_to_qvec(R)
        w, x, y, z = q
        R2 = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        np.testing.assert_allclose(R2, R, atol=1e-8)
        assert q[0] >= 0
        np.testing.assert_array_equal(q, jc.rotmat_to_qvec(R))


def test_database_roundtrip(tmp_path):
    path = str(tmp_path / "database.db")
    kps = np.array([[10.0, 20.0], [30.5, 40.5], [1.0, 2.0]], np.float32)
    matches = np.array([[0, 2], [1, 0]], np.uint32)
    with tc.ColmapDatabase(path) as db:
        cam = db.add_camera("PINHOLE", 640, 480, np.array([500.0, 500.0, 320.0, 240.0]))
        im1 = db.add_image("a.png", cam, prior_q=np.array([1.0, 0, 0, 0]), prior_t=np.array([0.0, 0, 1]))
        im2 = db.add_image("b.png", cam)
        db.add_keypoints(im1, kps)
        db.add_matches(im1, im2, matches)
        db.add_two_view_geometry(im1, im2, matches)

    conn = sqlite3.connect(path)
    model, w, h, params = conn.execute("SELECT model, width, height, params FROM cameras").fetchone()
    assert (model, w, h) == (1, 640, 480)
    np.testing.assert_allclose(np.frombuffer(params, np.float64), [500, 500, 320, 240])
    rows = conn.execute("SELECT image_id, name, prior_qw, prior_tz FROM images ORDER BY image_id").fetchall()
    assert rows[0][1] == "a.png" and rows[0][2] == 1.0 and rows[0][3] == 1.0
    assert rows[1][1] == "b.png"
    r, c, data = conn.execute("SELECT rows, cols, data FROM keypoints WHERE image_id=?", (im1,)).fetchone()
    np.testing.assert_allclose(np.frombuffer(data, np.float32).reshape(r, c)[:, :2], kps)
    pid = tc.pair_id_from_images(im1, im2)
    r, c, data = conn.execute("SELECT rows, cols, data FROM matches WHERE pair_id=?", (pid,)).fetchone()
    np.testing.assert_array_equal(np.frombuffer(data, np.uint32).reshape(r, c), matches)
    assert conn.execute("SELECT config FROM two_view_geometries WHERE pair_id=?", (pid,)).fetchone()[0] == 2
    conn.close()


def test_pair_id_ordering():
    assert tc.pair_id_from_images(3, 7) == tc.pair_id_from_images(7, 3)
    assert tc.pair_id_from_images(1, 2) != tc.pair_id_from_images(1, 3)
    assert tc.pair_id_from_images(3, 7) == jc.pair_id_from_images(3, 7)


def _frames():
    frames = {}
    for i in range(4):
        frames[i] = {"R": _rot("z", 0.1 * i).astype(np.float32), "T": np.array([0.0, 0, 0.5 * i], np.float32)}
    return frames


def _fake_slam():
    """A SLAM-shaped object of the port: intrinsics, frames and a map."""
    from lvdgs_torch.core.camera import Intrinsics
    from lvdgs_torch.gaussian.model import create_map

    gmap = create_map(16, "cpu")
    gmap = gmap.replace(
        means=torch.as_tensor(np.random.default_rng(0).normal(size=(16, 3)), dtype=torch.float32),
        active=torch.as_tensor([True] * 5 + [False] * 11),
    )
    return types.SimpleNamespace(intr=Intrinsics(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48),
                                 frames=_frames(), gmap=gmap, kf_indices=[0, 2])


def test_export_slam_to_colmap(tmp_path):
    slam = _fake_slam()

    def matcher(a, b):
        xy = np.array([[5.0, 6.0], [10.0, 12.0]], np.float32)
        return xy, xy + 1.0

    db_path = tc.export_slam_to_colmap(slam, str(tmp_path), match_pairs=[(0, 2)], matcher=matcher)
    conn = sqlite3.connect(db_path)
    assert conn.execute("SELECT COUNT(*) FROM images").fetchone()[0] == 4
    assert conn.execute("SELECT COUNT(*) FROM matches").fetchone()[0] == 1
    assert conn.execute("SELECT COUNT(*) FROM keypoints").fetchone()[0] == 2
    conn.close()

    sparse = tmp_path / "sparse"
    cam_lines = [ln for ln in (sparse / "cameras.txt").read_text().splitlines() if ln and not ln.startswith("#")]
    assert cam_lines[0].split()[:4] == ["1", "PINHOLE", "64", "48"]
    img_lines = [ln for ln in (sparse / "images.txt").read_text().splitlines() if ln and not ln.startswith("#")]
    assert len(img_lines) == 4
    v = img_lines[0].split()
    np.testing.assert_allclose([float(x) for x in v[1:8]], [1, 0, 0, 0, 0, 0, 0], atol=1e-12)
    pt_lines = [ln for ln in (sparse / "points3D.txt").read_text().splitlines() if ln and not ln.startswith("#")]
    assert len(pt_lines) == 5


def test_text_model_and_database_equal_the_reference(tmp_path):
    """export_text_model from the same NumPy frames and points writes the
    reference's three files byte for byte; the whole export of the same
    map (the port's on torch tensors, the reference's on JAX arrays) fills
    the same database rows and the same text model."""
    from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
    from lvdgs_tpu.gaussian.model import create_map as jcreate

    rng = np.random.default_rng(1)
    pts = rng.normal(size=(7, 3))
    rgb = rng.uniform(-0.1, 1.1, size=(7, 3))
    slam = _fake_slam()
    tc.export_text_model(str(tmp_path / "ours"), slam.intr, slam.frames, pts, rgb)
    jintr = JIntrinsics(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
    jc.export_text_model(str(tmp_path / "ref"), jintr, _frames(), pts, rgb)
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name

    import jax.numpy as jnp

    jmap = jcreate(16)
    jmap = jmap.replace(means=jnp.asarray(slam.gmap.means.numpy()), active=jnp.asarray(slam.gmap.active.numpy()))
    jslam = types.SimpleNamespace(intr=jintr, frames=_frames(), gmap=jmap, kf_indices=[0, 2])

    def matcher(a, b):
        xy = np.array([[5.0, 6.0], [10.0, 12.0], [1.5, 2.5]], np.float32) + a
        return xy, xy + b

    dbs = [mod.export_slam_to_colmap(s, str(tmp_path / tag), match_pairs=[(0, 2), (2, 3)], matcher=matcher)
           for mod, s, tag in ((tc, slam, "full_ours"), (jc, jslam, "full_ref"))]
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "full_ours" / "sparse" / name).read_bytes() == \
            (tmp_path / "full_ref" / "sparse" / name).read_bytes(), name
    tables = ("cameras", "images", "keypoints", "matches", "two_view_geometries")
    rows = []
    for path in dbs:
        conn = sqlite3.connect(path)
        rows.append({t: conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall() for t in tables})
        conn.close()
    assert rows[0] == rows[1]
    assert len(rows[0]["matches"]) == 2 and len(rows[0]["keypoints"]) == 3
