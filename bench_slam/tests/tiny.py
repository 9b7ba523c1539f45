"""A cell of the benchmark cut to a size the CPU runs in seconds: the
street at 128x48 (the 07 camera scaled), short budgets, 14 frames."""
from __future__ import annotations

import cells


def tiny_cell(name: str = "kitti07-seq"):
    cell = cells.find_cell(name)
    c = cell.config
    cal = c["Dataset"]["Calibration"]
    s = 128 / cal["width"]
    cal.update(width=128, height=48, fx=cal["fx"] * s, fy=cal["fy"] * s, cx=64.0, cy=24.0)
    c["Dataset"]["n_frames"] = 14
    c["Training"].update(init_itr_num=30, tracking_itr_num=10, mapping_itr_num=10, kf_interval=2,
                         plateau_min_iters=4)
    c["Performance"].update(max_per_tile=64, tile_chunk=16, map_capacity=16384, packed_tracking_budget=32,
                            packed_mapping_budget=32)
    cell.traffic = {**cell.traffic, "n_frames": 14,
                    "check": {"track": 2, "track_span": 2, "map": 1, "fwd": 2, "bwd": 2, "call_span": 20}}
    return cell
