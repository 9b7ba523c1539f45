"""COLMAP interchange: a sqlite database writer and a text-model export
(port of ``lvdgs_tpu/io/colmap.py``).

Writes cameras, images (with pose priors), keypoints and matches into the
standard COLMAP database schema, and dumps a SLAM result (trajectory and
Gaussian point cloud) as a COLMAP text model (cameras.txt / images.txt /
points3D.txt) for downstream COLMAP and novel-view pipelines.

Host code (the sqlite3 standard library); the only device interaction is
fetching the final map's active rows once.
"""
from __future__ import annotations

import os
import sqlite3
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""

CAMERA_MODELS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2,
                 "OPENCV": 4}


def pair_id_from_images(image_id1: int, image_id2: int) -> int:
    """COLMAP pair id convention (smaller id first)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> COLMAP (qw, qx, qy, qz)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


class ColmapDatabase:
    """Minimal writer for COLMAP's sqlite schema (the subset the
    reference's export populates: cameras, images with pose priors,
    keypoints, matches, two_view_geometries)."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def close(self) -> None:
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_camera(self, model: int | str, width: int, height: int,
                   params: np.ndarray, prior_focal_length: bool = True) -> int:
        if isinstance(model, str):
            model = CAMERA_MODELS[model]
        cur = self.conn.execute(
            "INSERT INTO cameras (model, width, height, params, "
            "prior_focal_length) VALUES (?, ?, ?, ?, ?)",
            (int(model), int(width), int(height),
             np.asarray(params, np.float64).tobytes(),
             int(prior_focal_length)),
        )
        return int(cur.lastrowid)

    def add_image(self, name: str, camera_id: int,
                  prior_q: Optional[np.ndarray] = None,
                  prior_t: Optional[np.ndarray] = None) -> int:
        q = np.full(4, np.nan) if prior_q is None else np.asarray(prior_q)
        t = np.full(3, np.nan) if prior_t is None else np.asarray(prior_t)
        cur = self.conn.execute(
            "INSERT INTO images (name, camera_id, prior_qw, prior_qx, "
            "prior_qy, prior_qz, prior_tx, prior_ty, prior_tz) "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (name, int(camera_id), *[float(v) for v in q],
             *[float(v) for v in t]),
        )
        return int(cur.lastrowid)

    def add_keypoints(self, image_id: int, xy: np.ndarray) -> None:
        """(N, 2) pixel coords; stored as COLMAP (N, 6) affine keypoints."""
        xy = np.asarray(xy, np.float32)
        kp = np.zeros((xy.shape[0], 6), np.float32)
        kp[:, :2] = xy
        kp[:, 2] = 1.0  # a11
        kp[:, 5] = 1.0  # a22
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints (image_id, rows, cols, data) "
            "VALUES (?, ?, ?, ?)",
            (int(image_id), kp.shape[0], kp.shape[1], kp.tobytes()),
        )

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray) -> None:
        """(M, 2) keypoint index pairs [idx_in_im1, idx_in_im2]."""
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pid = pair_id_from_images(image_id1, image_id2)
        self.conn.execute(
            "INSERT OR REPLACE INTO matches (pair_id, rows, cols, data) "
            "VALUES (?, ?, ?, ?)",
            (pid, matches.shape[0], 2, np.ascontiguousarray(matches).tobytes()),
        )

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray, config: int = 2) -> None:
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pid = pair_id_from_images(image_id1, image_id2)
        eye = np.eye(3, dtype=np.float64).tobytes()
        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries (pair_id, rows, "
            "cols, data, config, F, E, H, qvec, tvec) "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pid, matches.shape[0], 2,
             np.ascontiguousarray(matches).tobytes(), int(config),
             eye, eye, eye,
             np.array([1.0, 0, 0, 0]).tobytes(), np.zeros(3).tobytes()),
        )


def export_text_model(
    out_dir: str,
    intr,
    frames: Dict[int, dict],
    points_xyz: np.ndarray,
    points_rgb: np.ndarray,
    image_name_fmt: str = "{:05d}.png",
) -> None:
    """COLMAP text model (cameras.txt / images.txt / points3D.txt) from a
    SLAM trajectory + point cloud. Poses are world->camera, COLMAP's own
    convention, so frames' (R, T) records drop straight in."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(
            f"1 PINHOLE {intr.width} {intr.height} "
            f"{intr.fx} {intr.fy} {intr.cx} {intr.cy}\n"
        )
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, "
                "CAMERA_ID, NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i, idx in enumerate(sorted(frames), start=1):
            fr = frames[idx]
            q = rotmat_to_qvec(np.asarray(fr["R"], np.float64))
            t = np.asarray(fr["T"], np.float64)
            f.write(
                f"{i} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} 1 "
                + image_name_fmt.format(idx) + "\n\n"
            )
    pts = np.asarray(points_xyz, np.float64)
    rgb = np.clip(np.asarray(points_rgb, np.float64) * 255.0, 0, 255).astype(int)
    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for i in range(pts.shape[0]):
            x, y, z = pts[i]
            r, g, b = rgb[i]
            f.write(f"{i + 1} {x} {y} {z} {r} {g} {b} 0.0\n")


def export_slam_to_colmap(
    slam,
    out_dir: str,
    match_pairs: Optional[Iterable[Tuple[int, int]]] = None,
    matcher=None,
) -> str:
    """Full export of a SLAM run: database.db (cameras/images with the
    estimated poses as priors, plus keypoints/matches for the given
    keyframe pairs when a matcher is supplied) and the text model.

    `matcher(idx_a, idx_b) -> (xy_a (M,2), xy_b (M,2))` supplies pixel
    correspondences — e.g. MASt3R descriptors through
    fast_reciprocal_nns, the reference's own matching path
    (mast3r/colmap/database.py:93-176).
    Returns the database path."""
    os.makedirs(out_dir, exist_ok=True)
    intr = slam.intr
    db_path = os.path.join(out_dir, "database.db")
    act = slam.gmap.active
    means = slam.gmap.means[act].detach().cpu().numpy()
    colors = slam.gmap.colors[act].detach().cpu().numpy()
    export_text_model(os.path.join(out_dir, "sparse"), intr, slam.frames,
                      means, colors)

    with ColmapDatabase(db_path) as db:
        cam_id = db.add_camera(
            "PINHOLE", intr.width, intr.height,
            np.array([intr.fx, intr.fy, intr.cx, intr.cy]),
        )
        ids = {}
        kp_counts: Dict[int, int] = {}
        kp_store: Dict[int, list] = {}
        for idx in sorted(slam.frames):
            fr = slam.frames[idx]
            q = rotmat_to_qvec(np.asarray(fr["R"], np.float64))
            ids[idx] = db.add_image(
                f"{idx:05d}.png", cam_id, prior_q=q,
                prior_t=np.asarray(fr["T"], np.float64),
            )
            kp_store[idx] = []
            kp_counts[idx] = 0

        if matcher is not None and match_pairs is not None:
            for a, b in match_pairs:
                xy_a, xy_b = matcher(a, b)
                n = min(len(xy_a), len(xy_b))
                if n == 0:
                    continue
                ia = np.arange(kp_counts[a], kp_counts[a] + n, dtype=np.uint32)
                ib = np.arange(kp_counts[b], kp_counts[b] + n, dtype=np.uint32)
                kp_store[a].append(np.asarray(xy_a[:n], np.float32))
                kp_store[b].append(np.asarray(xy_b[:n], np.float32))
                kp_counts[a] += n
                kp_counts[b] += n
                m = np.stack([ia, ib], axis=1)
                db.add_matches(ids[a], ids[b], m)
                db.add_two_view_geometry(ids[a], ids[b], m)
            for idx, chunks in kp_store.items():
                if chunks:
                    db.add_keypoints(ids[idx], np.concatenate(chunks))
    return db_path
