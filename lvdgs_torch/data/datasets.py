"""Dataset parsers and loaders (PyTorch port).

Port of ``lvdgs_tpu/data/datasets.py``. Directory conventions are those of
the reference package (KITTI, Waymo, Replica, TUM, dl3dv parsers, copied as
NumPy code) plus the procedural synthetic scenes (``cloud`` and ``street``,
the street optionally with moving cars and their GT static mask), whose
frames are rendered by this package's own rasterizer on the dataset's
device.

``__getitem__`` returns (image (3, H, W) float32 in [0, 1], depth (H, W) or
None, w2c pose (4, 4) float32 NumPy, mono_depth (H, W) or None). File
datasets return NumPy arrays; the synthetic dataset returns tensors on its
device.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from PIL import Image

from ..core.camera import Intrinsics
from ..ops.rasterizer import SH_C0, RenderConfig, rasterize


def _rotmat_from_quat_xyzw(q):
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


# ---------------------------------------------------------------------------
# parsers


class KITTIParser:
    def __init__(self, input_folder: str, config):
        begin = config["Dataset"].get("begin", 0)
        end = config["Dataset"].get("end", None)
        self.color_paths = sorted(glob.glob(f"{input_folder}/image_2/*.jpg"))[begin:end]
        if not self.color_paths:
            self.color_paths = sorted(glob.glob(f"{input_folder}/image_2/*.png"))[begin:end]
        self.depth_paths = list(self.color_paths)
        self.mono_depth_paths = list(self.color_paths)
        self.n_img = len(self.color_paths)
        pose_files = sorted(glob.glob(f"{input_folder}gt/*.txt") or glob.glob(f"{input_folder}/gt/*.txt"))[
            begin:end
        ]
        self.poses = []
        init_trans = None
        for i in range(self.n_img):
            arr = np.loadtxt(pose_files[i], delimiter=" ")
            pose = np.eye(4)
            pose[:3, :] = arr.reshape(3, 4)
            if init_trans is None:
                init_trans = pose[:3, 3].copy()
            pose[:3, 3] -= init_trans
            self.poses.append(np.linalg.inv(pose))


class WaymoParser:
    def __init__(self, input_folder: str, config=None):
        self.color_paths = sorted(glob.glob(f"{input_folder}/rgb/*.png"))
        self.depth_paths = sorted(glob.glob(f"{input_folder}/depth/*.png"))
        self.mono_depth_paths = sorted(glob.glob(f"{input_folder}/mono_depth/*.png"))
        self.n_img = len(self.color_paths)
        pose_files = sorted(glob.glob(f"{input_folder}/gt/*.txt"))
        self.poses = [
            np.linalg.inv(np.loadtxt(pose_files[i], delimiter=" ").reshape(4, 4))
            for i in range(self.n_img)
        ]


class ReplicaParser:
    def __init__(self, input_folder: str, config=None):
        self.color_paths = sorted(glob.glob(f"{input_folder}/results/frame*.png"))
        self.depth_paths = sorted(glob.glob(f"{input_folder}/results/depth*.png"))
        self.mono_depth_paths = sorted(glob.glob(f"{input_folder}/results/mono*.png"))
        self.n_img = len(self.color_paths)
        traj = f"{input_folder}traj.txt"
        if not os.path.exists(traj):
            traj = os.path.join(input_folder, "traj.txt")
        with open(traj) as f:
            lines = f.readlines()
        self.poses = [
            np.linalg.inv(np.array(list(map(float, lines[i].split()))).reshape(4, 4))
            for i in range(self.n_img)
        ]


class TUMParser:
    def __init__(self, input_folder: str, config=None, frame_rate: int = 32):
        self.input_folder = input_folder
        self._load(input_folder, frame_rate)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(path, skiprows=0):
        return np.loadtxt(path, delimiter=" ", dtype=np.str_, skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        out = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_depth - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                out.append((i, j, k))
        return out

    def _load(self, datapath, frame_rate):
        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        mono_path = os.path.join(datapath, "mono_depth.txt")
        mono_data = self._parse_list(mono_path) if os.path.isfile(mono_path) else depth_data
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 0:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        self.color_paths, self.depth_paths, self.mono_depth_paths, self.poses = [], [], [], []
        for ix in indices:
            i, j, k = assoc[ix]
            self.color_paths.append(os.path.join(datapath, str(image_data[i, 1])))
            self.depth_paths.append(os.path.join(datapath, str(depth_data[j, 1])))
            self.mono_depth_paths.append(os.path.join(datapath, str(mono_data[min(i, len(mono_data) - 1), 1])))
            trans = pose_vecs[k][1:4]
            quat = pose_vecs[k][4:8]  # x y z w
            T = np.eye(4)
            T[:3, :3] = _rotmat_from_quat_xyzw(quat)
            T[:3, 3] = trans
            self.poses.append(np.linalg.inv(T))


class DL3DVParser:
    def __init__(self, input_folder: str, config):
        begin = config["Dataset"].get("begin", 0)
        end = config["Dataset"].get("end", None)
        self.color_paths = sorted(glob.glob(f"{input_folder}/rgb/*.png"))[begin:end]
        self.depth_paths = list(self.color_paths)
        self.mono_depth_paths = list(self.color_paths)
        self.n_img = len(self.color_paths)
        with open(os.path.join(input_folder, "cameras.json")) as f:
            all_poses = json.load(f)
        sel = all_poses[begin:end]
        init_trans = np.array(sel[0]["cam_trans"])
        self.poses = []
        for pose in sel:
            T = np.eye(4)
            T[:3, :3] = _rotmat_from_quat_xyzw(pose["cam_quat"])
            T[:3, 3] = np.array(pose["cam_trans"]) - init_trans
            self.poses.append(np.linalg.inv(T))


# ---------------------------------------------------------------------------
# datasets


class MonocularDataset:
    """Reference MonocularDataset parity (utils/dataset.py:263-344)."""

    PARSERS = {
        "KITTI": KITTIParser,
        "waymo": WaymoParser,
        "replica": ReplicaParser,
        "tum": TUMParser,
        "dl3dv": DL3DVParser,
    }

    def __init__(self, args, path, config):
        self.args = args
        self.path = path
        self.config = config
        calib = config["Dataset"]["Calibration"]
        self.intrinsics = Intrinsics(
            fx=calib["fx"],
            fy=calib["fy"],
            cx=calib["cx"],
            cy=calib["cy"],
            width=calib["width"],
            height=calib["height"],
        )
        self.fx, self.fy = calib["fx"], calib["fy"]
        self.cx, self.cy = calib["cx"], calib["cy"]
        self.width, self.height = calib["width"], calib["height"]
        self.fovx = self.intrinsics.fovx
        self.fovy = self.intrinsics.fovy
        self.K = self.intrinsics.K.astype(np.float64)

        self.disorted = calib.get("distorted", False)
        self.dist_coeffs = np.array(
            [calib.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")]
        )
        if self.disorted and cv2 is not None:
            self.map1x, self.map1y = cv2.initUndistortRectifyMap(
                self.K, self.dist_coeffs, np.eye(3), self.K,
                (self.width, self.height), cv2.CV_32FC1,
            )
        self.has_depth = "depth_scale" in calib
        self.depth_scale = calib.get("depth_scale")

        dtype = config["Dataset"]["type"]
        parser = self.PARSERS[dtype](config["Dataset"]["dataset_path"], config)
        self.color_paths = parser.color_paths
        self.depth_paths = parser.depth_paths
        self.mono_depth_paths = parser.mono_depth_paths
        self.poses = parser.poses
        self.num_imgs = parser.n_img

    def __len__(self):
        return self.num_imgs

    @staticmethod
    def _load_depth_image(path):
        arr = np.array(Image.open(path))
        if arr.ndim == 3:
            return arr[:, :, 0]
        return arr

    def __getitem__(self, idx):
        image = np.array(Image.open(self.color_paths[idx]))
        if self.disorted and cv2 is not None:
            image = cv2.remap(image, self.map1x, self.map1y, cv2.INTER_LINEAR)

        depth = mono_depth = None
        if self.has_depth:
            depth = self._load_depth_image(self.depth_paths[idx]) / self.depth_scale
            mono_depth = self._load_depth_image(self.mono_depth_paths[idx]) / (
                self.depth_scale * 5
            )
        image = np.clip(image / 255.0, 0.0, 1.0).transpose(2, 0, 1).astype(np.float32)
        pose = np.asarray(self.poses[idx], np.float32)
        return image, depth, pose, mono_depth


def _tex(x, z, seed=0.0):
    """Multi-octave procedural value texture in [0, 1] (deterministic)."""
    v = (
        0.30 * np.sin(1.7 * x + 0.9 * z + seed)
        + 0.22 * np.sin(4.3 * x - 2.1 * z + 2.0 * seed)
        + 0.14 * np.sin(11.0 * x + 7.0 * z + 3.0 * seed)
        + 0.08 * np.sin(23.0 * x - 17.0 * z + 5.0 * seed)
    )
    return 0.5 + 0.5 * np.tanh(v)


def _car_cluster(rng, x0, y_ground, z0, heading, tint, length=4.2, width=1.8,
                 height=1.5, sp=0.18):
    """Textured box-car surfel cluster (body sides/roof/ends + dark window
    band + wheels), centered at (x0, ·, z0) on the ground plane, facing
    `heading` (+1 = +z). Returns (means, colors, log_scales) numpy arrays."""
    means, colors, scales = [], [], []
    hl, hw = length / 2.0, width / 2.0
    y_top = y_ground - height  # y is down; roof above ground
    ys = np.arange(y_top, y_ground + 1e-6, sp)
    zs = np.arange(-hl, hl + 1e-6, sp)
    xs = np.arange(-hw, hw + 1e-6, sp)

    def _panel(px, py, pz, normal_axis):
        n = px.size
        tex = 0.75 + 0.25 * _tex(py * 3.1 + pz * 2.3, pz * 4.7, 31.0)
        col = np.asarray(tint)[None] * tex[:, None]
        # window band: dark glass on the upper third of the body
        win = (py < y_top + 0.45 * height) & (py > y_top + 0.08 * height)
        col[win] = np.array([0.10, 0.12, 0.15]) * (0.8 + 0.4 * tex[win, None])
        s = [0.12, 0.12, 0.12]
        s[normal_axis] = 0.015  # thin along the panel normal
        means.append(np.stack([px, py, pz], 1))
        colors.append(col)
        scales.append(np.tile(np.log(s), (n, 1)))

    # side panels (x = ±hw)
    for sx in (-hw, hw):
        py, pz = np.meshgrid(ys, zs)
        py, pz = py.ravel(), pz.ravel()
        _panel(np.full_like(py, sx), py, pz, 0)
    # front/back panels (z = ±hl)
    for sz in (-hl, hl):
        py, px = np.meshgrid(ys, xs)
        py, px = py.ravel(), px.ravel()
        _panel(px, py, np.full_like(py, sz), 2)
    # roof
    px, pz = np.meshgrid(xs, zs)
    px, pz = px.ravel(), pz.ravel()
    _panel(px, np.full_like(px, y_top), pz, 1)
    # wheels: dark blobs at the four corners
    for wz in (-hl * 0.62, hl * 0.62):
        for wx in (-hw, hw):
            means.append(np.array([[wx, y_ground - 0.3, wz]], np.float32))
            colors.append(np.array([[0.05, 0.05, 0.06]], np.float32))
            scales.append(np.log([[0.08, 0.3, 0.3]]).astype(np.float32))

    m = np.concatenate(means).astype(np.float32)
    c = np.concatenate(colors).astype(np.float32)
    s = np.concatenate(scales).astype(np.float32)
    if heading < 0:  # flip to face -z
        m[:, 2] = -m[:, 2]
    m[:, 0] += x0
    m[:, 2] += z0
    m[:, :2] += rng.normal(0, 0.01, (m.shape[0], 2))
    return m, np.clip(c, 0.0, 1.0), s


def _street_dynamic_objects(rng, scfg):
    """Moving objects of the dynamic street scene (Dataset.dynamic_objects):
    car clusters on linear paths, the objects the masking ladder exists to
    mask. Returns a list of {means, colors, log_scales, vel} dicts; `vel` is
    metres per frame in world space. The same draws from `rng` as the
    reference package's, so both build the same world."""
    n_obj = int(scfg.get("dynamic_objects", 0))
    if n_obj <= 0:
        return []
    step = scfg.get("step", 0.5)
    objs = []
    # archetypes: oncoming cars in the left lane (large image-space motion,
    # pass close to the camera) and a slower leading car ahead in our lane.
    # Overridable via Dataset.dynamic_archetypes: [[x, z0, heading, vz_per_
    # frame, r, g, b], ...] so tests can stage close encounters in few frames.
    archetypes = scfg.get("dynamic_archetypes") or [
        # (lane x, z at t=0, heading, vel z m/frame, tint)
        # Ordered transient-first: oncoming cars pass and exit (the
        # reference's demonstrable regime); the LEADING cars (ahead in our
        # lane, never exiting) permanently occlude the center-forward
        # corridor a masked run can then never seed — at 90 frames that
        # unobserved hole destabilises the masked run's window — so they
        # come last and only enter at dynamic_objects >= 3.
        (-1.75, 42.0, -1.0, -0.9 * step / 0.5, (0.75, 0.15, 0.12)),
        (-1.75, 80.0, -1.0, -1.1 * step / 0.5, (0.85, 0.80, 0.20)),
        (+1.75, 14.0, +1.0, +0.55 * step / 0.5, (0.15, 0.25, 0.70)),
        (+1.75, 45.0, +1.0, +0.5 * step / 0.5, (0.18, 0.55, 0.25)),
    ]
    archetypes = [
        (a[0], a[1], a[2], a[3],
         tuple(a[4]) if len(a) == 5 else tuple(a[4:7]),
         tuple(a[7:10]) if len(a) >= 10 else (4.2, 1.8, 1.5))
        for a in archetypes
    ]
    for i in range(min(n_obj, len(archetypes))):
        x0, z0, heading, vz, tint, (length, width, height) = archetypes[i]
        m, c, s = _car_cluster(rng, x0, 1.5, z0, heading, np.asarray(tint),
                               length=length, width=width, height=height)
        objs.append(
            {
                "means": m,
                "colors": c,
                "log_scales": s,
                "vel": np.array([0.0, 0.0, vz], np.float32),
            }
        )
    return objs


def _street_scene(rng, scfg):
    """Structured, textured street world for the real-data-faithful bench
    (VERDICT r2 #4): ground plane with lane markings, building facades with
    window grids, street furniture — all as thin surfel Gaussians with
    multi-octave procedural texture, KITTI-like depth range and geometry.
    Returns numpy param dict."""
    n_frames = scfg.get("n_frames", 120)
    step = scfg.get("step", 0.5)
    z_max = n_frames * step + 70.0
    half_w = scfg.get("street_half_width", 10.0)
    sp = scfg.get("street_spacing", 0.4)

    means, colors, scales = [], [], []

    # ---- ground plane (y=+1.5, camera at y=0, y down) with lane markings
    xs = np.arange(-half_w, half_w + 1e-6, sp)
    zs = np.arange(0.5, z_max, sp)
    gx, gz = np.meshgrid(xs, zs)
    gx = gx.ravel() + rng.normal(0, 0.05, gx.size)
    gz = gz.ravel() + rng.normal(0, 0.05, gx.size)
    gy = np.full_like(gx, 1.5) + 0.02 * np.sin(0.8 * gx) * np.sin(0.5 * gz)
    # asphalt: multi-octave base + high-frequency speckle (the looming of
    # ground texture is the dominant forward-motion signal)
    base = (0.18 + 0.12 * _tex(gx, gz, 1.0)
            + 0.06 * _tex(gx * 7.3, gz * 5.1, 4.0) - 0.03
            + rng.normal(0, 0.02, gx.size))
    # dashed center line + solid side lines
    lane = ((np.abs(gx) < 0.15) & ((gz % 6.0) < 3.0)) | (
        np.abs(np.abs(gx) - 3.5) < 0.12
    )
    gcol = np.stack([base, base, base], 1)
    gcol[lane] = 0.85
    means.append(np.stack([gx, gy, gz], 1))
    colors.append(gcol)
    scales.append(
        np.tile(np.log([0.35, 0.02, 0.35]), (gx.size, 1))
    )

    # ---- building facades at x = +-half_w, windows + per-building tint
    # (3-4 stories tall so the skyline, not black void, bounds the image)
    ys = np.arange(-9.0, 1.5 + 1e-6, sp)
    for side in (-1.0, 1.0):
        wy, wz = np.meshgrid(ys, zs)
        wy = wy.ravel() + rng.normal(0, 0.03, wy.size)
        wz2 = wz.ravel() + rng.normal(0, 0.03, wy.size)
        wx = np.full_like(wy, side * half_w) + rng.normal(0, 0.02, wy.size)
        bid = np.floor(wz2 / 18.0)  # building id -> tint
        tint = np.stack(
            [
                0.35 + 0.3 * _tex(bid, bid, 7.0),
                0.30 + 0.3 * _tex(bid, bid, 11.0),
                0.28 + 0.3 * _tex(bid, bid, 17.0),
            ],
            1,
        )
        fac = 0.6 + 0.4 * _tex(wy * 2.0, wz2 * 2.0, 3.0)
        wcol = tint * fac[:, None]
        # window grid: dark recessed cells
        win = ((wy % 1.4) < 0.7) & ((wz2 % 2.6) < 1.3) & (wy < 0.8)
        wcol[win] *= 0.35
        means.append(np.stack([wx, wy, wz2], 1))
        colors.append(wcol)
        scales.append(np.tile(np.log([0.02, 0.35, 0.35]), (wy.size, 1)))

    # ---- street furniture: poles with small cross pieces
    n_poles = max(4, int(z_max / 12.0))
    for side in (-1.0, 1.0):
        pz = rng.uniform(4.0, z_max - 5.0, n_poles)
        for z0 in pz:
            py = np.arange(-3.2, 1.5, 0.25)
            px = np.full_like(py, side * (half_w - 3.0))
            means.append(
                np.stack([px, py, np.full_like(py, z0)], 1)
            )
            c = 0.3 + 0.2 * _tex(py, np.full_like(py, z0), 9.0)
            colors.append(np.stack([c, c, c * 0.9], 1))
            scales.append(np.tile(np.log([0.06, 0.14, 0.06]), (py.size, 1)))

    # ---- far backplane: building skyline at the vanishing point below the
    # horizon, gradient sky with cloud texture above — fills the whole image
    # beyond the corridor so no region renders to pure black (pure-black
    # pixels fall outside valid_rgb and carry no tracking signal)
    ex = np.arange(-6 * half_w, 6 * half_w, 0.8)
    ey = np.arange(-45.0, 2.0, 0.8)
    mx, my = np.meshgrid(ex, ey)
    mx, my = mx.ravel(), my.ravel()
    mz = np.full_like(mx, z_max + 5.0)
    sky = my < -8.0  # above the skyline
    c = 0.45 + 0.3 * _tex(mx * 0.3, my * 0.3, 13.0)
    wall_col = np.stack([c * 0.75, c * 0.8, c * 0.85], 1)
    # sky: brightness gradient toward zenith + low-frequency cloud mottling
    elev = np.clip((-my - 8.0) / 37.0, 0.0, 1.0)
    cloud = 0.12 * _tex(mx * 0.08, my * 0.15, 21.0)
    sky_col = np.stack(
        [0.55 + 0.15 * elev + cloud,
         0.65 + 0.15 * elev + cloud,
         0.85 + 0.10 * elev + 0.5 * cloud], 1)
    col = np.where(sky[:, None], sky_col, wall_col)
    means.append(np.stack([mx, my, mz], 1))
    colors.append(np.clip(col, 0.0, 1.0))
    scales.append(np.tile(np.log([0.7, 0.7, 0.05]), (mx.size, 1)))

    means = np.concatenate(means).astype(np.float32)
    colors = np.concatenate(colors).astype(np.float32)
    scales = np.concatenate(scales).astype(np.float32)
    n = means.shape[0]
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    return {
        "means": means,
        # colors enter rendering as clip(0.5 + SH_C0 * dc): invert
        "features_dc": (colors - 0.5) / SH_C0,
        "log_scales": scales,
        "quats": quats,
        "logit_opacities": np.full((n,), 4.0, np.float32),
    }



class SyntheticDataset:
    """Procedural Gaussian-world dataset: a fixed Gaussian scene rendered
    along a smooth trajectory with this package's rasterizer, giving
    photometrically consistent RGB, exact depth and ground-truth poses."""

    def __init__(self, args, path, config, device):
        scfg = config["Dataset"]
        calib = scfg["Calibration"]
        self.device = torch.device(device)
        self.intrinsics = Intrinsics(
            fx=calib["fx"], fy=calib["fy"], cx=calib["cx"], cy=calib["cy"],
            width=calib["width"], height=calib["height"],
        )
        self.fx, self.fy = calib["fx"], calib["fy"]
        self.cx, self.cy = calib["cx"], calib["cy"]
        self.width, self.height = calib["width"], calib["height"]
        self.fovx, self.fovy = self.intrinsics.fovx, self.intrinsics.fovy
        self.K = self.intrinsics.K
        self.disorted = False
        self.dist_coeffs = np.zeros(5)
        self.has_depth = True
        self.depth_scale = 1.0
        self.num_imgs = scfg.get("n_frames", 30)

        rng = np.random.default_rng(scfg.get("seed", 0))
        self._dynamic = []  # moving-object specs (street scene only)
        if scfg.get("scene", "cloud") == "street":
            params_np = _street_scene(rng, scfg)
            n_static = params_np["means"].shape[0]
            # moving objects (Dataset.dynamic_objects > 0) are appended to the
            # parameter arrays, so every frame renders the same shapes; a
            # frame moves only their means
            dyns = _street_dynamic_objects(rng, scfg)
            if dyns:
                dm = np.concatenate([d["means"] for d in dyns])
                nd = dm.shape[0]
                params_np = {
                    "means": np.concatenate([params_np["means"], dm]),
                    "features_dc": np.concatenate(
                        [params_np["features_dc"],
                         (np.concatenate([d["colors"] for d in dyns]) - 0.5) / SH_C0]),
                    "log_scales": np.concatenate(
                        [params_np["log_scales"], np.concatenate([d["log_scales"] for d in dyns])]),
                    "quats": np.concatenate(
                        [params_np["quats"], np.tile(np.array([1, 0, 0, 0], np.float32), (nd, 1))]),
                    "logit_opacities": np.concatenate(
                        [params_np["logit_opacities"], np.full((nd,), 4.0, np.float32)]),
                }
                f32 = dict(dtype=torch.float32, device=self.device)
                self._dyn_base_means = torch.as_tensor(dm, **f32)
                self._dyn_vel = torch.as_tensor(
                    np.concatenate([np.tile(d["vel"], (d["means"].shape[0], 1)) for d in dyns]), **f32)
                self._dynamic = dyns
                # marker colours for the GT-mask render: dynamic Gaussians
                # render 1, static ones 0, with the same geometry and
                # opacity, so the blended marker is each pixel's dynamic
                # coverage, occlusion included (threshold 0.5)
                marker = np.zeros((params_np["means"].shape[0],), np.float32)
                marker[n_static:] = 1.0
                self._marker_dc = torch.as_tensor(
                    np.tile(((marker - 0.5) / SH_C0)[:, None], (1, 3)), **f32)
            self._n_static = n_static
        else:
            n = scfg.get("n_gaussians", 4000)
            spread = scfg.get("spread", 4.0)
            means = np.concatenate(
                [rng.normal(size=(n, 2)) * spread, rng.uniform(4.0, 14.0, size=(n, 1))], axis=1
            )
            params_np = {
                "means": means,
                "features_dc": rng.normal(size=(n, 3)),
                "log_scales": rng.uniform(-2.0, -0.9, size=(n, 3)),
                "quats": rng.normal(size=(n, 4)),
                "logit_opacities": rng.uniform(1.5, 4.0, size=(n,)),
            }
        self._params = {
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            for k, v in params_np.items()
        }
        n = self._params["means"].shape[0]
        self._active = torch.ones((n,), dtype=torch.bool, device=self.device)
        # photometric realism knobs (street bench): per-frame exposure
        # gain/bias, sensor noise, and a degraded mono-depth prior
        self._photo_gain = scfg.get("photo_gain_jitter", 0.0)
        self._photo_bias = scfg.get("photo_bias_jitter", 0.0)
        self._photo_noise = scfg.get("photo_noise", 0.0)
        self._mono_scale = scfg.get("mono_scale_error", 1.0)
        self._mono_noise = scfg.get("mono_noise", 0.0)
        self._rcfg = RenderConfig(
            tile_size=16, max_per_tile=scfg.get("max_per_tile", 256), tile_chunk=64,
        )

        # smooth forward + lateral trajectory (w2c poses); `accel_frames`
        # ramps the forward speed linearly from rest
        step = scfg.get("step", 0.06)
        accel_frames = scfg.get("accel_frames", 0)
        self.poses = []
        zpos = 0.0
        for i in range(self.num_imgs):
            v = step * min(1.0, i / accel_frames) if accel_frames else step
            zpos += v
            t = np.array([0.3 * np.sin(i * 0.15), 0.05 * np.sin(i * 0.08), -zpos])
            ang = 0.02 * np.sin(i * 0.1)
            R = np.array(
                [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
            )
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = t
            self.poses.append(T.astype(np.float32))
        self._cache = {}

    def __len__(self):
        return self.num_imgs

    def _frame_generator(self, stream: int, idx: int) -> torch.Generator:
        """Deterministic per-frame noise source (one stream per quantity)."""
        return torch.Generator(device=self.device).manual_seed(stream * 1_000_003 + idx)

    def frame_params(self, idx: int) -> dict:
        """The scene's parameters at frame `idx`: the moving objects'
        means advanced by `idx` frames of their velocity."""
        if not self._dynamic:
            return self._params
        moved = self._dyn_base_means + float(idx) * self._dyn_vel
        return {**self._params,
                "means": torch.cat([self._params["means"][: self._n_static], moved])}

    @torch.no_grad()
    def static_mask_coverage(self, idx: int):
        """(cov, opacity), each (H, W): frame `idx` re-rendered with the
        marker colours, cov the opacity-normalised marker (each pixel's
        dynamic coverage, occlusion included) and the render's opacity."""
        pose = self.poses[idx]
        mout = rasterize(
            {**self.frame_params(idx), "features_dc": self._marker_dc}, self._active,
            torch.as_tensor(pose[:3, :3], device=self.device),
            torch.as_tensor(pose[:3, 3], device=self.device),
            self.intrinsics, self._rcfg, need_n_touched=False,
        )
        op = mout.opacity[0]
        return mout.image[0] / torch.clamp(op, min=1e-6), op

    @torch.no_grad()
    def __getitem__(self, idx):
        if idx not in self._cache:
            pose = self.poses[idx]
            out = rasterize(
                self.frame_params(idx), self._active,
                torch.as_tensor(pose[:3, :3], device=self.device),
                torch.as_tensor(pose[:3, 3], device=self.device),
                self.intrinsics, self._rcfg, need_n_touched=False,
            )
            op = out.opacity[0]
            depth = torch.where(op > 0.5, out.depth[0] / torch.clamp(op, min=1e-6),
                                torch.zeros_like(op))
            image = out.image
            mono = depth
            if self._photo_gain or self._photo_bias or self._photo_noise:
                # per-frame camera auto-exposure + sensor noise; the SLAM side
                # absorbs gain/bias with its exposure affine
                g = self._frame_generator(911, idx)
                u = torch.rand(2, generator=g, device=self.device) * 2.0 - 1.0
                gain = 1.0 + self._photo_gain * u[0]
                bias = self._photo_bias * u[1]
                noise = self._photo_noise * torch.randn(image.shape, generator=g, device=self.device)
                image = torch.clamp(image * gain + bias + noise, 0.0, 1.0)
            if self._mono_scale != 1.0 or self._mono_noise:
                # global scale error + multiplicative noise of a mono prior
                g = self._frame_generator(13, idx)
                mono = depth * self._mono_scale * (
                    1.0 + self._mono_noise * torch.randn(depth.shape, generator=g, device=self.device)
                )
                mono = torch.clamp(mono, min=0.0)
            static_mask = None
            if self._dynamic:
                # a pixel is dynamic where its dynamic coverage reaches 0.5
                # and it is covered (opacity at least 0.5)
                cov, op = self.static_mask_coverage(idx)
                static_mask = (cov < 0.5) | (op < 0.5)
            self._cache[idx] = (image, depth, mono, static_mask)
        image, depth, mono, _ = self._cache[idx]
        return image, depth, self.poses[idx], mono

    def get_gt_static_mask(self, idx):
        """(H, W) bool GT static mask (True = static) of a dynamic street
        frame, on the dataset's device; None for a scene without moving
        objects. The oracle maskers and the static-region metrics read it."""
        if not self._dynamic:
            return None
        if idx not in self._cache:
            self.__getitem__(idx)
        return self._cache[idx][3]


def load_dataset(args, path, config, device):
    """Dataset dispatch by ``Dataset.type``."""
    dtype = config["Dataset"]["type"]
    if dtype == "synthetic":
        return SyntheticDataset(args, path, config, device)
    if dtype in MonocularDataset.PARSERS:
        return MonocularDataset(args, path, config)
    raise ValueError(f"Unknown dataset type: {dtype}")
