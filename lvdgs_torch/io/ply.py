"""Gaussian map <-> 3DGS-convention PLY interop (port of
``lvdgs_tpu/io/ply.py``).

`save_gaussians_ply` writes the standard Inria-3DGS binary layout
(x,y,z,nx,ny,nz,f_dc_*,opacity,scale_*,rot_*) so maps saved here open in any
3DGS viewer, matching the reference save_gaussians artifact
(utils/eval_utils_0806.py:440-449: point_cloud/{final|iteration_N}/point_cloud.ply).
Only active Gaussians are written.
"""
from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np


_PROPS = (
    ["x", "y", "z", "nx", "ny", "nz"]
    + [f"f_dc_{i}" for i in range(3)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)


def save_gaussians_ply(gmap, path: str) -> int:
    """Write active Gaussians; returns count."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    def host(x):
        return x.detach().cpu().numpy()

    active = host(gmap.active)
    means = host(gmap.means)[active]
    fdc = host(gmap.features_dc)[active]
    opac = host(gmap.logit_opacities)[active]
    scales = host(gmap.log_scales)[active]
    # PLY convention stores wxyz rot as rot_0..rot_3
    quats = host(gmap.quats)[active]
    n = means.shape[0]

    data = np.concatenate(
        [
            means,
            np.zeros((n, 3), np.float32),  # normals
            fdc,
            opac[:, None],
            scales,
            quats,
        ],
        axis=1,
    ).astype("<f4")

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in _PROPS)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
    return n


def load_gaussians_ply(path: str) -> Tuple[np.ndarray, ...]:
    """Read a 3DGS PLY -> (means, features_dc, log_scales, quats,
    logit_opacities) numpy arrays."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n = 0
        props = []
        for ln in lines:
            if ln.startswith("element vertex"):
                n = int(ln.split()[-1])
            elif ln.startswith("property float"):
                props.append(ln.split()[-1])
        raw = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4").reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}
    means = raw[:, [col["x"], col["y"], col["z"]]]
    fdc = raw[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]]
    scales = raw[:, [col["scale_0"], col["scale_1"], col["scale_2"]]]
    quats = raw[:, [col["rot_0"], col["rot_1"], col["rot_2"], col["rot_3"]]]
    opac = raw[:, col["opacity"]]
    return means, fdc, scales, quats, opac
