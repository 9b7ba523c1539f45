"""GUI data packets and a headless viewer (port of
``lvdgs_tpu/gui/gui_utils.py``).

`GaussianPacket` carries a snapshot of the map and the current frame to a
visualisation consumer. The snapshot is host NumPy (the active rows of the
map, detached and copied off the device); the `HeadlessViewer` consumer
writes the render frames (`live_NNNNNN.png`), the map as a PLY
(`live_map.ply`) and the pose feed (`trajectory.jsonl`) to disk on a worker
thread, in the reference's formats, so that `tools/replay_viewer.py` and
`tools/live_viewer.py` follow a run without a display server.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class GaussianPacket:
    """Snapshot message frontend -> GUI (reference gui_utils.GaussianPacket
    fields: gaussians, current_frame, gtcolor, gtdepth, keyframes,
    kf_window)."""

    gaussians: Optional[dict] = None  # numpy dict of map arrays (active only)
    current_frame: Optional[dict] = None  # {"R", "T", "uid"}
    gtcolor: Optional[np.ndarray] = None
    gtdepth: Optional[np.ndarray] = None
    keyframes: Optional[List[dict]] = None
    kf_window: Optional[Dict[int, List[int]]] = None
    render: Optional[np.ndarray] = None
    finish: bool = False


@dataclasses.dataclass
class ControlPacket:
    """GUI -> main (reference vis2main messages with flag_pause)."""

    flag_pause: bool = False


def snapshot_gaussians(gmap) -> dict:
    """The active Gaussians as host NumPy: means, colours, opacities,
    scales and quaternions, detached and copied off the map's device."""
    active = gmap.active

    def rows(t):
        return t[active].detach().cpu().numpy()

    return {"means": rows(gmap.means), "colors": rows(gmap.colors), "opacities": rows(gmap.opacities),
            "scales": rows(gmap.scaling), "quats": rows(gmap.quats)}


class HeadlessViewer:
    """File-backed viewer: consumes GaussianPackets on a worker thread and
    writes renders / live point cloud under `out_dir`."""

    def __init__(self, out_dir: str, every: int = 1):
        self.out_dir = out_dir
        self.every = every
        self.q: "queue.Queue[GaussianPacket]" = queue.Queue(maxsize=8)
        self._n = 0
        os.makedirs(out_dir, exist_ok=True)
        # fresh pose feed per run: append mode below would otherwise mix
        # records from earlier runs into the same save_dir, desyncing
        # replay_viewer's n-based pairing with live_*.png frames
        trj = os.path.join(out_dir, "trajectory.jsonl")
        if os.path.exists(trj):
            os.remove(trj)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def put(self, packet: GaussianPacket) -> None:
        try:
            self.q.put_nowait(packet)
        except queue.Full:  # drop frames rather than stall SLAM
            pass

    def close(self) -> None:
        self.q.put(GaussianPacket(finish=True))
        self._thread.join(timeout=10)

    # ------------------------------------------------------------------

    def _run(self) -> None:
        while True:
            pkt = self.q.get()
            if pkt.finish:
                return
            self._n += 1
            if self._n % self.every:
                continue
            try:
                self._consume(pkt)
            except Exception:
                pass

    def _consume(self, pkt: GaussianPacket) -> None:
        from PIL import Image

        if pkt.render is not None:
            img = (np.clip(pkt.render, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(self.out_dir, f"live_{self._n:06d}.png")
            )
        if pkt.gaussians is not None:
            self._write_ply(pkt.gaussians, os.path.join(self.out_dir, "live_map.ply"))
        if pkt.current_frame is not None:
            # append-only pose feed: tools/replay_viewer.py consumes this to
            # draw the live trajectory + keyframe markers (parity target:
            # the reference Open3D viewer's camera trail,
            # utils/slam_frontend.py:1524-1531)
            import json

            rec = {
                "n": self._n,
                "frame": _pose_record(pkt.current_frame),
                "keyframes": [_pose_record(k) for k in (pkt.keyframes or [])],
                "kf_window": {
                    str(k): list(map(int, v))
                    for k, v in (pkt.kf_window or {}).items()
                },
            }
            with open(os.path.join(self.out_dir, "trajectory.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")

    @staticmethod
    def _write_ply(g: dict, path: str) -> None:
        means = g["means"]
        cols = (np.clip(g["colors"], 0, 1) * 255).astype(np.uint8)
        n = means.shape[0]
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        rec = np.zeros(
            n,
            dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
        )
        rec["xyz"] = means.astype("<f4")
        rec["rgb"] = cols
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(rec.tobytes())


def _pose_record(d: dict) -> dict:
    """Serializable {uid, R, T} from a packet pose dict (w2c)."""
    return {
        "uid": int(d.get("uid", -1)),
        "R": np.asarray(d["R"]).reshape(3, 3).tolist(),
        "T": np.asarray(d["T"]).reshape(3).tolist(),
    }


class FakeQueue:
    """No-op queue for GUI-off mode (reference
    utils/multiprocessing_utils.py:7-19)."""

    def put(self, *a, **k):
        pass

    def get_nowait(self):
        raise queue.Empty

    def get(self, *a, **k):
        raise queue.Empty

    def qsize(self):
        return 0

    def empty(self):
        return True
