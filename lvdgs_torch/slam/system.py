"""Single-process SLAM orchestrator (PyTorch port of
``lvdgs_tpu/slam/system.py``).

Host side: dataset IO, keyframe policy, window management, per-frame
bookkeeping, evaluation. Device side: tracking, mapping, seeding, pruning.
The steps run in the reference order: seed + init mapping on frame 0;
per frame, tracking from a pose seed; on a keyframe, median-depth fusion
with patch scale alignment, seeding, windowed mapping and covisibility
prune; at the end colour refinement, ATE and render metrics.

Rendering: on CUDA, tracking renders packed at 96 slots per tile and
mapping (init, windowed, colour refinement) at 128, both with saturation
feedback, as the reference does off the CPU; on the CPU both render dense.
The exact renders (eval, covisibility prune, tracking's final bookkeeping
render, median-depth fusion) stay dense. Performance.packed_*_budget and
saturation_feedback[_mapping] override the defaults; Performance.blend_bf16
runs the packed tracking and mapping renders' weight math in bfloat16.

Configuration keys and defaults are those of the reference package. Paths
that this package does not carry yet raise NotImplementedError naming the
ROADMAP item: the active-prefix binning bucket (C4), global BA and
checkpoints (A7/A8), dynamic filtering (A11), MASt3R priors (A12), the GUI
and the visualisation panels (A14) and data-parallel mapping (A15).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import lie
from ..core.camera import Camera, Intrinsics
from ..core.config import DotDict
from ..core.log import Log, PhaseTimer
from ..core.losses import compute_grad_mask
from ..data.datasets import load_dataset
from ..data.prefetch import PrefetchLoader
from ..eval.ate import eval_ate
from ..eval.rendering import eval_rendering
from ..gaussian import model as gm
from ..io.ply import save_gaussians_ply
from ..ops.rasterizer import RenderConfig, rasterize_median_depth
from . import state as slam_state
from .depth_alignment import process_depth
from .keyframe import add_to_window, is_keyframe, visibility_pair_stats, visibility_window_stats
from .mapping import (
    MappingConfig, color_refine_run, covisibility_prune, covisibility_prune_from_occ, mapping_run,
)
from .tracking import TrackingConfig, track_camera, track_camera_pyramid


def resolve_device(device=None) -> torch.device:
    """The run's device: CUDA unless the caller asks for another. Raises
    when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _refuse_unported(config: dict) -> None:
    perf = config.get("Performance", {}) or {}
    tr = config.get("Training", {}) or {}
    res = config.get("Results", {}) or {}
    checks = [
        (perf.get("bin_active_bucket", False), "the active-prefix binning bucket (ROADMAP C4)"),
        (perf.get("data_parallel", False), "data-parallel mapping (ROADMAP A15)"),
        (res.get("global_BA", False), "global bundle adjustment (ROADMAP A7)"),
        (res.get("use_gui", False), "the GUI feed (ROADMAP A14)"),
        (res.get("save_depth_comparison", False),
         "the depth-comparison panels, Results.save_depth_comparison (ROADMAP A14)"),
        # only an explicit non-zero value: the reference's default of 1
        # writes best-effort panels that the port does not write yet
        (res.get("viz_every", 0), "the eval visualisation panels, Results.viz_every (ROADMAP A14)"),
        ((config.get("dynamic_filtering", {}) or {}).get("enabled", False),
         "dynamic filtering (ROADMAP A11)"),
        ((config.get("mast3r", {}) or {}).get("checkpoint"), "MASt3R priors (ROADMAP A12)"),
    ]
    for asked, what in checks:
        if asked:
            raise NotImplementedError(f"lvdgs_torch does not carry {what} yet")


class SLAM:
    """End-to-end monocular Gaussian-splatting SLAM."""

    def __init__(self, config: dict, save_dir: Optional[str] = None, device=None):
        _refuse_unported(config)
        self.device = resolve_device(device)
        self.config = config
        self.save_dir = save_dir or config.get("Results", {}).get("save_dir", "results")
        tr = config["Training"]
        ds_cfg = config["Dataset"]
        opt_params = DotDict(config.get("opt_params", {}))
        if tr.get("pose_seed") == "sim_prior" and ds_cfg.get("type", "KITTI") != "synthetic":
            raise ValueError(
                "pose_seed=sim_prior is a GT-derived prior emulation for synthetic "
                f"benches only; refusing on dataset type '{ds_cfg.get('type')}'"
            )

        self.dataset = load_dataset(None, ds_cfg.get("dataset_path", ""), config, self.device)
        self.intr: Intrinsics = self.dataset.intrinsics

        perf = config.get("Performance", {})
        self.rcfg = RenderConfig(
            tile_size=perf.get("tile_size", 16),
            max_per_tile=perf.get("max_per_tile", 512),
            tile_chunk=perf.get("tile_chunk", 128),
            white_background=config.get("model_params", {}).get("white_background", False),
        )
        # packed (group-CSR) render budgets per path, 0 = dense: on CUDA
        # tracking at 96 and mapping at 128 slots per tile with saturation
        # feedback (192 without), on the CPU dense, as the reference sets
        # them off and on its CPU. Exact renders keep self.rcfg. blend_bf16
        # (bf16 weight math) reaches only these two optimiser-facing configs.
        on_cpu = self.device.type == "cpu"
        tb = perf.get("packed_tracking_budget", 0 if on_cpu else 96)
        sat_t = perf.get("saturation_feedback", True)
        sat_m = perf.get("saturation_feedback_mapping", True)
        mb = perf.get("packed_mapping_budget", 0 if on_cpu else (128 if sat_m else 192))
        bfb = perf.get("blend_bf16", False)
        self.rcfg_track = (dataclasses.replace(self.rcfg, use_packed=True, slot_budget_per_tile=tb,
                                               saturation_feedback=sat_t, blend_bf16=bfb)
                           if tb else self.rcfg)
        self.rcfg_map = (dataclasses.replace(self.rcfg, use_packed=True, slot_budget_per_tile=mb,
                                             saturation_feedback=sat_m, blend_bf16=bfb)
                         if mb else self.rcfg)
        # synced_timers: end each timed phase with a device synchronise so
        # the phase timers read device time (costs one sync per phase)
        self.synced_timers = bool(int(os.environ.get("LVDGS_SYNCED_TIMERS", "0"))) or perf.get(
            "synced_timers", False
        )
        # LVDGS_NAN_SCAN=1: after every SLAM phase, count the non-finite rows
        # of each map parameter (active and inactive apart) and of the
        # phase's output, and log the phase that shows them. One host
        # transfer per phase: for debugging only.
        self._nan_scan_on = os.environ.get("LVDGS_NAN_SCAN", "") == "1"
        # the map starts small and grows by powers of two toward
        # map_capacity as it fills
        self.max_capacity = perf.get("map_capacity", 2**17)
        capacity = min(perf.get("map_capacity_init", 2**14), self.max_capacity)
        kf_capacity = perf.get("kf_capacity", 512)

        self.monocular = tr.get("monocular", True)
        self.cameras_extent = float(config.get("model_params", {}).get("cameras_extent", 6.0))
        self.gmap = gm.create_map(capacity, self.device)
        self.opt = gm.MapOptimizer(
            feature_lr=opt_params.get("feature_lr", 0.0025),
            opacity_lr=opt_params.get("opacity_lr", 0.05),
            scaling_lr=opt_params.get("scaling_lr", 0.001),
            rotation_lr=opt_params.get("rotation_lr", 0.001),
            position_lr_init=opt_params.get("position_lr_init", 0.0016),
            position_lr_final=opt_params.get("position_lr_final", 0.00016),
            position_lr_max_steps=opt_params.get("position_lr_max_steps", 30000),
            spatial_scale=self.cameras_extent,
        )
        self.opt_state = self.opt.init(self.gmap)
        self.kfbuf = slam_state.create_keyframe_buffer(
            kf_capacity, self.intr.height, self.intr.width, self.device
        )

        self.tcfg = TrackingConfig(
            max_iters=tr.get("tracking_itr_num", 100),
            lr_rot=tr["lr"]["cam_rot_delta"],
            lr_trans=tr["lr"]["cam_trans_delta"],
            rgb_boundary_threshold=tr.get("rgb_boundary_threshold", 0.01),
            convergence_eps=tr.get("convergence_eps", 1e-4),
            plateau_tol=tr.get("plateau_tol", 0.005),
            plateau_min_iters=tr.get("plateau_min_iters", 40),
            # coarse-to-fine tracking (track_camera_pyramid)
            pyramid=bool(tr.get("track_pyramid", False)),
            coarse_iters=tr.get("track_coarse_iters", 60),
            coarse_min_iters=tr.get("track_coarse_min_iters", 20),
            fine_min_iters=tr.get("track_fine_min_iters", 20),
            use_static_mask=bool(tr.get("tracking_use_mask", False)),
        )
        common = dict(
            window_size=tr.get("window_size", 8),
            pose_window=tr.get("pose_window", 3),
            lambda_dssim=opt_params.get("lambda_dssim", 0.2),
            depth_lambda=tr.get("depth_lambda", 0.1),
            alpha=tr.get("alpha", 0.95),
            rgb_boundary_threshold=tr.get("rgb_boundary_threshold", 0.01),
            lr_rot=tr["lr"]["cam_rot_delta"] * 0.5,
            lr_trans=tr["lr"]["cam_trans_delta"] * 0.5,
            densify_grad_threshold=opt_params.get("densify_grad_threshold", 0.0002),
            percent_dense=opt_params.get("percent_dense", 0.01),
            gaussian_update_every=tr.get("gaussian_update_every", 150),
            gaussian_update_offset=tr.get("gaussian_update_offset", 50),
            gaussian_th=tr.get("gaussian_th", 0.7),
            gaussian_extent=self.cameras_extent * tr.get("gaussian_extent", 1.0),
            gaussian_reset=tr.get("gaussian_reset", 2001),
            size_threshold=tr.get("size_threshold", 20),
            monocular=self.monocular,
            rebin_every=perf.get("rebin_every", 20),
            bin_margin=perf.get("bin_margin", 16.0),
        )
        self.mcfg = MappingConfig(**common)
        self.mcfg_ba = MappingConfig(**{**common, "pose_window": tr.get("window_size", 8) - 1})
        self.mcfg_init = MappingConfig(
            window_size=1,
            n_random=0,
            initialization=True,
            init_gaussian_update=tr.get("init_gaussian_update", 100),
            init_gaussian_reset=tr.get("init_gaussian_reset", 500),
            init_gaussian_th=tr.get("init_gaussian_th", 0.005),
            init_gaussian_extent=self.cameras_extent * tr.get("init_gaussian_extent", 30),
            densify_from_iter=opt_params.get("densify_from_iter", 500),
            densify_grad_threshold=opt_params.get("densify_grad_threshold", 0.0002),
            alpha=tr.get("alpha", 0.95),
            rgb_boundary_threshold=tr.get("rgb_boundary_threshold", 0.01),
            monocular=self.monocular,
            rebin_every=perf.get("init_rebin_every", 2),
            bin_margin=perf.get("bin_margin", 8.0),
        )

        # policy hyper-parameters
        self.kf_interval = tr.get("kf_interval", 5)
        self.kf_time_gate = tr.get("kf_time_gate", False)
        self.window_size = tr.get("window_size", 8)
        self.single_thread = tr.get("single_thread", True)
        self.kf_translation = tr.get("kf_translation", 0.08)
        self.kf_min_translation = tr.get("kf_min_translation", 0.05)
        self.kf_overlap = tr.get("kf_overlap", 0.9)
        self.kf_cutoff = tr.get("kf_cutoff", 0.3)
        self.prune_num = tr.get("prune_num", 1)
        self.init_itr_num = tr.get("init_itr_num", 1050)
        self.mapping_itr_num = tr.get("mapping_itr_num", 150)
        self.mapping_itr_nosingle = tr.get("mapping_itr_nosingle", 10)
        self.pcd_downsample = ds_cfg.get("pcd_downsample", 64)
        self.pcd_downsample_init = ds_cfg.get("pcd_downsample_init", 32)
        self.point_size = ds_cfg.get("point_size", 0.01)
        self.adaptive_pointsize = ds_cfg.get("adaptive_pointsize", True)
        self.depth_cfg = config.get("depth", {})
        # "median" renders the transmittance-median depth for keyframe
        # fusion; "alpha" keeps the raw alpha-blended render depth
        self.depth_fusion_source = tr.get("depth_fusion_source", "median")
        self.mono_scale_anchor = tr.get("mono_scale_anchor", True)
        self.mono_scale_anchor_tol = tr.get("mono_scale_anchor_tol", 0.1)
        self.mono_scale_servo = tr.get("mono_scale_servo", True)
        self.mono_scale_servo_deadband = tr.get("mono_scale_servo_deadband", 0.02)
        self.mono_scale_servo_window = tr.get("mono_scale_servo_window", 5)
        self.mono_scale_servo_gain = tr.get("mono_scale_servo_gain", 0.5)
        self.mono_scale_servo_max_step = tr.get("mono_scale_servo_max_step", 0.05)
        self._servo_obs: list = []
        self.scale_telemetry = tr.get("scale_telemetry", True)
        self._anchor_scales: list = []
        self._mono_anchor_val: Optional[float] = None
        self.pose_seed_mode = tr.get("pose_seed", "constant_velocity")
        if self.pose_seed_mode == "sim_prior":
            Log("pose_seed=sim_prior: GT-derived pose-prior emulation active — results "
                "are NOT prior-free")
        self.sim_prior_trans_noise = tr.get("sim_prior_trans_noise", 0.02)
        self.sim_prior_rot_noise_deg = tr.get("sim_prior_rot_noise_deg", 0.2)
        # observe the map scale at the init keyframe too (see _initialize);
        # False keeps the reference's scale of 1.0 until the second keyframe
        self.sim_prior_scale_at_init = tr.get("sim_prior_scale_at_init", True)
        self._map_scale_obs: Optional[float] = None
        self._scale_history: list = []
        self.mono_depth_source = ds_cfg.get("mono_depth_source", "dataset")

        res = config.get("Results", {})
        self.save_results = res.get("save_results", True)
        self.save_trj = res.get("save_trj", True)
        self.save_trj_kf_intv = res.get("save_trj_kf_intv", 10)
        self.do_color_refinement = res.get("color_refinement", True)
        self.color_refinement_iters = res.get("color_refinement_iters", 26000)
        self.do_eval_rendering = res.get("eval_rendering", True)

        # mutable state
        self.last_sent = 0  # idle-mapping counter (threaded mode)
        self.idle_debt = 0  # accrued idle iterations, flushed in bursts
        self._last_curr_vis = None
        self._last_track_stats = None
        self._cached_num_active: Optional[int] = None
        self._last_resize_kf = -10
        self.frames: Dict[int, dict] = {}
        self.kf_indices: List[int] = []
        self.kf_slots: Dict[int, int] = {}
        self.current_window: List[int] = []
        self.occ_visibility: Dict[int, torch.Tensor] = {}
        self.initialized = not self.monocular
        self.iteration_count = 0
        self.median_depth = 1.0
        self.generator = torch.Generator().manual_seed(int(config.get("seed", 0)))
        self.timer = PhaseTimer()
        self.frames_processed = 0
        self._cams: Dict[int, Camera] = {}
        # prune visibility: the mapping run's final-iteration visibility
        # (default) or a fresh exact render of the window
        self.exact_prune_visibility = perf.get("exact_prune_visibility", False)
        # mapping runs are split into segments of at most this many
        # iterations per rendered camera; each segment restarts the
        # keyframe-pose Adam moments, as in the reference
        self.max_iters_per_dispatch = perf.get("max_iters_per_dispatch", 300)

    # ------------------------------------------------------------------ utils

    def _phase_sync(self) -> None:
        if self.synced_timers and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_mapping(self, window_slots: List[int], n_iters: int, mcfg: MappingConfig):
        n_cams = mcfg.window_size + mcfg.n_random
        seg_limit = max(1, self.max_iters_per_dispatch // max(1, n_cams))
        local_it = 0
        res = None
        remaining = int(n_iters)
        while remaining > 0:
            seg = min(remaining, seg_limit)
            res = mapping_run(
                self.gmap, self.opt_state, self.kfbuf, window_slots, self.generator,
                self.iteration_count, seg, local_it,
                intr=self.intr, rcfg=self.rcfg_map, opt=self.opt, mcfg=mcfg,
            )
            self.iteration_count = res.iteration_count
            local_it += seg
            remaining -= seg
            # densification may approach the capacity ceiling mid-run
            if remaining > 0 and self.gmap.capacity < self.max_capacity:
                if self.gmap.num_active > 0.7 * self.gmap.capacity:
                    self._grow_to(self.gmap.capacity * 2)
        return res

    def _store_frame_record(self, idx: int, packed: np.ndarray) -> None:
        self.frames[idx] = {
            "R": packed[0:9].reshape(3, 3),
            "T": packed[9:12],
            "R_gt": packed[12:21].reshape(3, 3),
            "T_gt": packed[21:24],
            "exposure_a": float(packed[24]),
            "exposure_b": float(packed[25]),
            "static_mask": None,
        }

    @staticmethod
    def _pose_record(cam: Camera) -> torch.Tensor:
        return torch.cat([
            cam.R.reshape(-1), cam.T, cam.R_gt.reshape(-1), cam.T_gt,
            torch.stack([cam.exposure_a, cam.exposure_b]),
        ])

    def _record_frame(self, idx: int, cam: Camera) -> None:
        self._store_frame_record(idx, self._pose_record(cam).cpu().numpy())

    def _mono_depth_for(self, depth, mono) -> torch.Tensor:
        if self.mono_depth_source == "gt" and depth is not None:
            return torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        if mono is not None:
            return torch.as_tensor(mono, dtype=torch.float32, device=self.device)
        return torch.zeros((self.intr.height, self.intr.width), dtype=torch.float32, device=self.device)

    def _build_camera(self, idx: int, sample=None) -> Camera:
        image, depth, pose, mono = self.dataset[idx] if sample is None else sample
        f32 = dict(dtype=torch.float32, device=self.device)
        cam = Camera.create(
            idx, torch.as_tensor(image, **f32), self.intr,
            gt_R=torch.as_tensor(np.asarray(pose[:3, :3]), **f32),
            gt_T=torch.as_tensor(np.asarray(pose[:3, 3]), **f32),
            depth=None if depth is None else torch.as_tensor(depth, **f32),
        )
        return cam.replace(
            mono_depth=self._mono_depth_for(depth, mono),
            grad_mask=compute_grad_mask(
                cam.image,
                self.config["Training"].get("edge_threshold", 1.1),
                self.config["Dataset"].get("type", "KITTI"),
            ),
        )

    def _map_scale_estimate(self) -> float:
        """Map scale relative to GT for the sim_prior pose seed: the last
        rendered/GT depth observation, else the estimated/GT keyframe
        baseline ratio."""
        if self._map_scale_obs is not None:
            return self._map_scale_obs
        kfs = self.kf_indices[-6:]
        ratios = []
        for a, b in zip(kfs[:-1], kfs[1:]):
            fa, fb = self.frames[a], self.frames[b]
            ca = -np.asarray(fa["R"]).T @ np.asarray(fa["T"])
            cb = -np.asarray(fb["R"]).T @ np.asarray(fb["T"])
            ga = -np.asarray(fa["R_gt"]).T @ np.asarray(fa["T_gt"])
            gb = -np.asarray(fb["R_gt"]).T @ np.asarray(fb["T_gt"])
            g = float(np.linalg.norm(ga - gb))
            if g > 1e-6:
                ratios.append(float(np.linalg.norm(ca - cb)) / g)
        return float(np.median(ratios)) if ratios else 1.0

    @torch.no_grad()
    def _observe_map_scale(self, render_depth: torch.Tensor, cam: Camera) -> None:
        """Record median(rendered depth / GT depth) at a new keyframe."""
        rd, gd = render_depth, cam.depth
        ok = (rd > 0.1) & (gd > 0.1) & torch.isfinite(rd) & torch.isfinite(gd)
        ratio = torch.sort((rd / torch.clamp(gd, min=1e-6))[ok]).values
        n = ratio.numel()
        med = 0.5 * (ratio[(n - 1) // 2] + ratio[n // 2]) if n else torch.tensor(float("nan"))
        med, n = float(med), int(n)
        if n >= 100 and np.isfinite(med):
            self._map_scale_obs = med
            self._scale_history.append((int(cam.uid), med))
            if len(self._scale_history) > 4096:
                del self._scale_history[:-4096]

    def _pose_seed(self, idx: int, cam: Camera) -> Camera:
        f32 = dict(dtype=torch.float32, device=self.device)
        mode = self.pose_seed_mode
        if mode == "gt":
            return cam.update_RT(cam.R_gt, cam.T_gt)
        if mode == "sim_prior":
            # emulated pointmap-PnP prior: GT relative pose from the last
            # keyframe in map scale, with a deterministic PnP-class error,
            # composed onto the ESTIMATED keyframe pose (synthetic only)
            kf_idx = self.current_window[0] if self.current_window else 0
            kf = self.frames.get(kf_idx)
            if kf is not None:
                R_gt = cam.R_gt.cpu().numpy().astype(np.float64)
                T_gt = cam.T_gt.cpu().numpy().astype(np.float64)
                R_rel = R_gt @ np.asarray(kf["R_gt"]).T
                T_rel = T_gt - R_rel @ np.asarray(kf["T_gt"])
                T_rel = self._map_scale_estimate() * T_rel
                rng = np.random.default_rng(917 + idx)
                tau = np.concatenate([
                    rng.normal(size=3) * self.sim_prior_trans_noise,
                    rng.normal(size=3) * np.radians(self.sim_prior_rot_noise_deg),
                ]).astype(np.float32)
                Rn, Tn = lie.apply_delta(
                    torch.as_tensor(R_rel, dtype=torch.float32),
                    torch.as_tensor(T_rel, dtype=torch.float32),
                    torch.as_tensor(tau),
                )
                Rn, Tn = Rn.numpy(), Tn.numpy()
                R_seed = Rn @ np.asarray(kf["R"])
                T_seed = Rn @ np.asarray(kf["T"]) + Tn
                return cam.update_RT(torch.as_tensor(R_seed, **f32), torch.as_tensor(T_seed, **f32))
        prev = self.frames.get(idx - 1)
        if prev is None:
            return cam
        if mode == "constant_velocity" and (idx - 2) in self.frames:
            p1, p2 = self.frames[idx - 1], self.frames[idx - 2]
            T1 = np.eye(4)
            T1[:3, :3], T1[:3, 3] = p1["R"], p1["T"]
            T2 = np.eye(4)
            T2[:3, :3], T2[:3, 3] = p2["R"], p2["T"]
            seed = T1 @ np.linalg.inv(T2) @ T1
            return cam.update_RT(torch.as_tensor(seed[:3, :3], **f32), torch.as_tensor(seed[:3, 3], **f32))
        return cam.update_RT(torch.as_tensor(prev["R"], **f32), torch.as_tensor(prev["T"], **f32))

    # ----------------------------------------------------------- keyframe add

    @torch.no_grad()
    def _fused_keyframe_depth(self, idx: int, cam: Camera, render_depth, init: bool):
        """Valid-RGB masking, mono depth for init, patch-based scale
        alignment against the rendered depth otherwise (with the mono-scale
        anchor and optional gauge servo). Returns (depth for seeding, cam
        with rescaled mono_depth)."""
        rgb_thr = self.config["Training"].get("rgb_boundary_threshold", 0.01)
        valid_rgb = cam.image.sum(dim=0) > rgb_thr
        if init or render_depth is None:
            return torch.where(valid_rgb, cam.mono_depth, torch.zeros_like(cam.mono_depth)), cam

        dc = self.depth_cfg
        thr = dc.get("final_error_threshold", 0.15)
        fused, scale, _err, _nacc = process_depth(
            render_depth, cam.mono_depth,
            patch_size=dc.get("patch_size", 10),
            mean_threshold=dc.get("mean_threshold", 0.25),
            std_threshold=dc.get("std_threshold", 0.3),
            error_threshold=dc.get("error_threshold", 0.1),
            final_error_threshold=thr,
            min_accurate_pixels_ratio=dc.get("min_accurate_pixels_ratio", 0.01),
        )
        scale = float(scale)
        if self.mono_scale_anchor:
            # clamp the mono->render alignment scale to a band around the
            # run's initial scale (the monocular gauge otherwise walks)
            s_raw = scale
            if self._mono_anchor_val is None:
                self._anchor_scales.append(s_raw)
                if len(self._anchor_scales) >= 3:
                    self._mono_anchor_val = float(np.median(self._anchor_scales))
            else:
                if self.mono_scale_servo and np.isfinite(s_raw) and s_raw > 0:
                    # gauge servo: rescale the whole world toward the anchor
                    # (median of recent observations, partial gain, clipped)
                    self._servo_obs.append(s_raw)
                    del self._servo_obs[: -self.mono_scale_servo_window]
                    drift = float(np.median(self._servo_obs)) / self._mono_anchor_val
                    if abs(drift - 1.0) > self.mono_scale_servo_deadband:
                        step = self.mono_scale_servo_max_step
                        k = float(np.clip(drift ** -self.mono_scale_servo_gain, 1.0 - step, 1.0 + step))
                        cam = self._apply_gauge_correction(k, cam)
                        fused = fused * k
                        scale = s_raw * k
                        self._servo_obs = [s * k for s in self._servo_obs]
                    k_applied = scale / s_raw
                else:
                    k_applied = 1.0
                tol = self.mono_scale_anchor_tol
                lo = self._mono_anchor_val * (1.0 - tol)
                hi = self._mono_anchor_val * (1.0 + tol)
                if not (lo <= scale <= hi):
                    s_c = float(np.clip(scale, lo, hi))
                    mono_scaled = cam.mono_depth * s_c
                    rd = render_depth * k_applied
                    rel = (rd - mono_scaled).abs() / (mono_scaled + 1e-8)
                    fused = torch.where((rel > thr) | (rd == 0.0), mono_scaled, rd)
                    scale = s_c
        cam = cam.replace(mono_depth=cam.mono_depth * scale)
        return torch.where(valid_rgb, fused, torch.zeros_like(fused)), cam

    @torch.no_grad()
    def _apply_gauge_correction(self, k: float, cam: Camera) -> Camera:
        """Similarity-rescale the estimated world by `k` about the origin:
        map, keyframe poses and mono depths, window cameras, the recorded
        trajectory and the scale observation. Rendering is invariant."""
        gm.gauge_rescale(self.gmap, self.opt_state, k)
        self.kfbuf.T.mul_(k)
        self.kfbuf.mono_depth.mul_(k)
        for i in self.current_window:
            c = self._cams.get(i)
            if c is not None:
                self._cams[i] = c.replace(T=c.T * k, mono_depth=c.mono_depth * k)
        for f in self.frames.values():
            f["T"] = np.asarray(f["T"], np.float32) * k
        if self._map_scale_obs is not None:
            self._map_scale_obs = float(self._map_scale_obs) * k
        self.median_depth = float(self.median_depth) * k
        Log(f"gauge servo: world rescaled by {k:.4f} (anchor {self._mono_anchor_val:.4f})")
        return cam.replace(T=cam.T * k)

    def _grow_to(self, target: int) -> None:
        cap = self.gmap.capacity
        self._last_resize_kf = len(self.kf_indices)
        Log(f"Growing map capacity {cap} -> {target}")
        self.gmap, self.opt_state = gm.grow_capacity(self.gmap, target, self.opt_state)
        self.occ_visibility = {
            k: torch.cat([v, v.new_zeros(target - v.shape[0])]) if v.shape[0] < target else v
            for k, v in self.occ_visibility.items()
        }

    def _maybe_shrink(self) -> None:
        """Shrink capacity after large prunes (grow at 0.7 occupancy, shrink
        only when actives fit in 0.2 of half, never within 5 keyframes of
        a resize)."""
        if len(self.kf_indices) - self._last_resize_kf < 5:
            return
        cap = self.gmap.capacity
        n = self._num_active_cached()
        min_cap = min(2**14, self.max_capacity)
        target = cap
        while target > min_cap and n <= 0.2 * (target // 2):
            target //= 2
        if target >= cap:
            return
        self._last_resize_kf = len(self.kf_indices)
        Log(f"Shrinking map capacity {cap} -> {target} ({n} active)")
        self.gmap, self.opt_state, take = gm.compact_and_resize(self.gmap, target, self.opt_state)
        self.occ_visibility = {k: v[take] for k, v in self.occ_visibility.items()}

    def _num_active_cached(self) -> int:
        if self._cached_num_active is None:
            return self.gmap.num_active
        return self._cached_num_active

    def _ensure_capacity(self, downsample: int) -> None:
        """Grow the map (powers of two, up to map_capacity) when the next
        seeding could approach saturation."""
        stride = max(1, int(round(np.sqrt(max(1, downsample)))))
        cand = -(-self.intr.height // stride) * (-(-self.intr.width // stride))
        need = self._num_active_cached() + cand
        cap = self.gmap.capacity
        target = cap
        while need > 0.7 * target and target < self.max_capacity:
            target *= 2
        target = min(target, self.max_capacity)
        if target > cap:
            self._grow_to(target)

    def _backend_init(self, idx: int, cam: Camera, depth) -> None:
        self._ensure_capacity(self.pcd_downsample_init)
        gm.seed_from_depth(
            self.gmap, cam, depth, self.intr, kf_id=idx, downsample=self.pcd_downsample_init,
            point_size=self.point_size, adaptive_pointsize=self.adaptive_pointsize,
            opt_state=self.opt_state,
        )
        res = self._run_mapping([self.kf_slots[idx]], self.init_itr_num, self.mcfg_init)
        self.occ_visibility[idx] = res.occ_visibility[0]
        self._nan_scan(f"backend_init[{idx}]", depth)
        Log(f"Initialized map ({self.gmap.num_active} gaussians)")

    def _backend_keyframe(self, idx: int, depth) -> None:
        cam = self._cams[idx]
        self.timer.tic("kf_seed")
        self._ensure_capacity(self.pcd_downsample)
        self._cached_num_active = None
        gm.seed_from_depth(
            self.gmap, cam, depth, self.intr, kf_id=idx, downsample=self.pcd_downsample,
            point_size=self.point_size, adaptive_pointsize=self.adaptive_pointsize,
            opt_state=self.opt_state,
        )
        self._phase_sync()
        self._nan_scan(f"kf_seed[{idx}]", depth)
        self.timer.toc("kf_seed")
        mcfg = self.mcfg
        if not self.initialized:
            if len(self.current_window) == self.window_size:
                iter_per_kf = 300  # initial BA
                mcfg = self.mcfg_ba
                Log("Performing initial BA for initialization")
            else:
                iter_per_kf = self.mapping_itr_num
        else:
            iter_per_kf = self.mapping_itr_num if self.single_thread else self.mapping_itr_nosingle
        # fold accrued idle iterations into this run
        iter_per_kf += self.idle_debt
        self.idle_debt = 0

        window_slots = self._window_slots()
        self.timer.tic("kf_mapping")
        res = self._run_mapping(window_slots, iter_per_kf, mcfg)
        self._phase_sync()
        self._nan_scan(f"kf_mapping[{idx}]")
        self.timer.toc("kf_mapping")

        self.timer.tic("kf_prune")
        occ, self.initialized = self._prune(window_slots, res)
        for i, kf_idx in enumerate(self.current_window):
            self.occ_visibility[kf_idx] = occ[i]
        self._sync_backend()
        self._maybe_shrink()
        self._phase_sync()
        self._nan_scan(f"kf_prune[{idx}]")
        self.timer.toc("kf_prune")

    def _prune(self, window_slots, mapping_res):
        if self.exact_prune_visibility or mapping_res is None:
            return covisibility_prune(
                self.gmap, self.kfbuf, window_slots, self.initialized, intr=self.intr,
                rcfg=self.rcfg, prune_num=self.prune_num, window_size=self.window_size,
            )
        return covisibility_prune_from_occ(
            self.gmap, self.kfbuf, window_slots, mapping_res.occ_visibility, self.initialized,
            prune_num=self.prune_num, window_size=self.window_size,
        )

    def _nan_scan(self, where: str, extra=None) -> None:
        """With LVDGS_NAN_SCAN=1, log which map parameters hold NaN or Inf
        (rows counted apart for active and inactive Gaussians) and how many
        non-finite values the phase output `extra` holds, tagged with the
        phase: the first tag logged names the phase that brought them in."""
        if not self._nan_scan_on:
            return
        msgs = []
        act = self.gmap.active
        for k, v in self.gmap.params().items():
            bad = ~torch.isfinite(v)
            if bad.dim() > 1:
                bad = bad.any(dim=1)
            na, ni = int(bad[act].sum()), int(bad[~act].sum())
            if na or ni:
                msgs.append(f"{k}(act={na},inact={ni})")
        if extra is not None:
            nb = int((~torch.isfinite(torch.as_tensor(extra))).sum())
            if nb:
                msgs.append(f"phase_out({nb})")
        if msgs:
            Log(f"NANSCAN[{where}]: " + " ".join(msgs), tag="Debug")

    def _window_slots(self) -> List[int]:
        slots = [self.kf_slots[k] for k in self.current_window]
        return slots + [-1] * (self.window_size - len(slots))

    def _sync_backend(self) -> None:
        """Adopt refined keyframe poses/exposures; one host transfer also
        carries the live active count."""
        M = self.kfbuf.capacity
        packed = torch.cat([
            self.kfbuf.R.reshape(M, 9), self.kfbuf.T, self.kfbuf.exposure_ab,
            self.gmap.active.sum().to(torch.float32).expand(M, 1),
        ], dim=1).cpu().numpy()
        self._cached_num_active = int(packed[0, 14])
        for kf_idx in self.current_window:
            slot = self.kf_slots[kf_idx]
            self.frames[kf_idx]["R"] = packed[slot, 0:9].reshape(3, 3)
            self.frames[kf_idx]["T"] = packed[slot, 9:12]
            self.frames[kf_idx]["exposure_a"] = float(packed[slot, 12])
            self.frames[kf_idx]["exposure_b"] = float(packed[slot, 13])
            if kf_idx in self._cams:
                self._cams[kf_idx] = self._cams[kf_idx].update_RT(
                    self.kfbuf.R[slot].clone(), self.kfbuf.T[slot].clone()
                )

    # ------------------------------------------------------------- main steps

    def _initialize(self, idx: int, cam: Camera) -> None:
        cam = cam.update_RT(cam.R_gt, cam.T_gt)
        self._cams[idx] = cam
        self._record_frame(idx, cam)
        depth, cam = self._fused_keyframe_depth(idx, cam, None, init=True)
        self._cams[idx] = cam
        self.kf_indices.append(idx)
        self.kf_slots[idx] = slam_state.add_keyframe(self.kfbuf, cam)
        self.current_window = [idx]
        self._backend_init(idx, cam, depth)
        if self.pose_seed_mode == "sim_prior" and self.sim_prior_scale_at_init:
            # The emulated prior is a relative pose in map scale, as the real
            # PnP against rendered depth is. The map takes its scale from
            # the init frame's mono depth, so observe it here as at every
            # later keyframe (_make_keyframe): with the fallback of 1.0
            # until the second keyframe, the street scene's seeds overshoot
            # by 1/0.8, tracking takes back only part of it, and the scale
            # observed at the second keyframe, which every later seed
            # inherits, can come out wrong (ROADMAP C6).
            md, _mo = rasterize_median_depth(self.gmap.params(), self.gmap.active, cam.R, cam.T,
                                             self.intr, self.rcfg)
            self._observe_map_scale(md[0], cam)

    def _track(self, idx: int, cam: Camera):
        cam = self._pose_seed(idx, cam)
        track = track_camera_pyramid if self.tcfg.pyramid else track_camera
        res = track(self.gmap.params(), self.gmap.active, cam, self.intr, self.rcfg_track, self.tcfg)
        cam = cam.update_RT(res.R, res.T).replace(exposure_a=res.exposure_a, exposure_b=res.exposure_b)
        self._cams[idx] = cam
        last_kf = self.current_window[0] if self.current_window else None
        last_vis = (self.occ_visibility[last_kf] if last_kf in self.occ_visibility
                    else torch.zeros_like(self.gmap.active))
        curr_vis = res.n_touched > 0
        # one host transfer for the pose record, median depth and policy stats
        packed = torch.cat([
            self._pose_record(cam), res.median_depth.reshape(1),
            visibility_pair_stats(curr_vis, last_vis).to(torch.float32),
        ]).cpu().numpy()
        self._store_frame_record(idx, packed)
        self.median_depth = float(packed[26])
        self._last_track_stats = packed[27:31].astype(np.int64)
        self._last_curr_vis = curr_vis
        return cam, res

    def _make_keyframe(self, idx: int, cam: Camera, track_res, curr_vis) -> None:
        if self.current_window:
            occ_stack = torch.stack([self.occ_visibility[k] for k in self.current_window])
            wstats = visibility_window_stats(curr_vis, occ_stack).cpu().numpy()
            ratios = {
                k: int(wstats[i, 0]) / max(min(int(wstats[i, 1]), int(wstats[i, 2])), 1)
                for i, k in enumerate(self.current_window)
            }
        else:
            ratios = None
        self.current_window, removed = add_to_window(
            cur_frame_idx=idx, overlap_min_ratios=ratios, curr_visibility=curr_vis,
            occ_visibility=self.occ_visibility, window=self.current_window,
            poses={k: (self.frames[k]["R"], self.frames[k]["T"]) for k in [idx] + self.current_window},
            window_size=self.window_size, kf_cutoff=self.kf_cutoff, initialized=self.initialized,
        )
        if removed is not None:
            self.occ_visibility.pop(removed, None)

        self.timer.tic("kf_fusion")
        render_depth = track_res.depth[0]
        if self.depth_fusion_source == "median":
            md, _mo = rasterize_median_depth(
                self.gmap.params(), self.gmap.active, cam.R, cam.T, self.intr, self.rcfg
            )
            render_depth = md[0]
        if self.pose_seed_mode == "sim_prior" or self.scale_telemetry:
            self._observe_map_scale(render_depth, cam)
        depth, cam = self._fused_keyframe_depth(idx, cam, render_depth, init=False)
        self._phase_sync()
        self.timer.toc("kf_fusion")
        self._cams[idx] = cam
        self.kf_indices.append(idx)
        self.kf_slots[idx] = slam_state.add_keyframe(self.kfbuf, cam)
        self._backend_keyframe(idx, depth)

    def process_frame(self, idx: int, sample=None) -> None:
        self.timer.tic("camera")
        cam = self._build_camera(idx, sample)
        self._phase_sync()
        self.timer.toc("camera")
        if idx == 0 or not self.current_window:
            self._initialize(idx, cam)
            self.frames_processed += 1
            return

        self.initialized = self.initialized or len(self.current_window) == self.window_size
        self.timer.tic("tracking")
        cam, res = self._track(idx, cam)
        self.timer.toc("tracking")
        if self._nan_scan_on:
            self._nan_scan(f"track[{idx}]", torch.cat([cam.R.reshape(-1), cam.T.reshape(-1)]))

        last_kf_idx = self.current_window[0]
        check_time = (idx - last_kf_idx) >= self.kf_interval
        curr_vis = self._last_curr_vis
        stats = self._last_track_stats
        create_kf = is_keyframe(
            curr_R=self.frames[idx]["R"], curr_T=self.frames[idx]["T"],
            last_kf_R=self.frames[last_kf_idx]["R"], last_kf_T=self.frames[last_kf_idx]["T"],
            median_depth=self.median_depth, curr_visibility=curr_vis,
            last_kf_visibility=self.occ_visibility[last_kf_idx],
            kf_translation=self.kf_translation, kf_min_translation=self.kf_min_translation,
            kf_overlap=self.kf_overlap, overlap_stats=stats,
        )
        if len(self.current_window) < self.window_size:
            create_kf = check_time and (int(stats[2]) / max(int(stats[3]), 1)) < self.kf_overlap
        if self.single_thread or self.kf_time_gate:
            create_kf = check_time and create_kf

        if create_kf:
            self.timer.tic("mapping")
            self._make_keyframe(idx, cam, res, curr_vis=curr_vis)
            self.timer.toc("mapping")
            self.last_sent = 0
        elif not self.single_thread and self.current_window:
            # threaded mode: idle mapping accrues one iteration per frame,
            # flushed with a prune every 10 frames
            self.timer.tic("idle_mapping")
            self.idle_debt += 1
            self.last_sent += 1
            if self.last_sent >= 10:
                idle_res = self._run_mapping(self._window_slots(), 10 + self.idle_debt, self.mcfg)
                self.idle_debt = 0
                occ, self.initialized = self._prune(self._window_slots(), idle_res)
                for i, kf_idx in enumerate(self.current_window):
                    self.occ_visibility[kf_idx] = occ[i]
                self._sync_backend()
                self.last_sent = 0
                self._phase_sync()
                self._nan_scan(f"idle_mapping[{idx}]")
            self.timer.toc("idle_mapping")
        self.frames_processed += 1

        if self.save_results and self.save_trj and create_kf and \
                len(self.kf_indices) % self.save_trj_kf_intv == 0:
            eval_ate(self.frames, self.kf_indices, self.save_dir, idx, monocular=self.monocular)

    def _start_profiler(self, profile_dir: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts,
                                      on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))
        prof.start()
        return prof

    def _stop_profiler(self, prof, profile_dir: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        Log(f"profiler trace written to {profile_dir}")

    def color_refinement(self, iters: Optional[int] = None,
                         features_only: Optional[bool] = None) -> None:
        iters = iters or self.color_refinement_iters
        if features_only is None:
            features_only = self.config.get("Results", {}).get("refine_features_only", False)
        Log(f"Starting color refinement ({iters} iters{', features-only' if features_only else ''})")
        color_refine_run(
            self.gmap, self.opt_state, self.kfbuf, self.generator, iters, 0,
            intr=self.intr, rcfg=self.rcfg_map, opt=self.opt, mcfg=self.mcfg,
            features_only=bool(features_only),
        )
        self._nan_scan(f"color_refine[{iters}]")
        Log("Map refinement done")

    def run(self, n_frames: Optional[int] = None, progress: bool = True) -> dict:
        n = len(self.dataset) if n_frames is None else min(n_frames, len(self.dataset))
        start = self.frames_processed
        loader = PrefetchLoader(self.dataset, depth=4, start=start, end=n)
        # optional torch.profiler trace of the loop from frame start +
        # profile_after for profile_frames more frames, written into
        # profile_dir (TensorBoard's and Chrome's trace format)
        res = self.config.get("Results", {})
        profile_dir = res.get("profile_dir")
        profile_after = int(res.get("profile_after", 5))
        profile_frames = int(res.get("profile_frames", 10))
        profiler = None
        # the reference's pacing: sleep so that keyframes arrive at no more
        # than pace_kf_hz; 0 disables it
        pace_hz = float(self.config.get("Training", {}).get("pace_kf_hz", 0.0))
        t0 = time.perf_counter()
        try:
            for idx, sample in loader:
                f_start = time.perf_counter()
                kfs_before = len(self.kf_indices)
                if profile_dir and profiler is None and idx - start == profile_after:
                    profiler = self._start_profiler(profile_dir)
                self.process_frame(idx, sample)
                if profiler is not None and idx - start >= profile_after + profile_frames:
                    self._stop_profiler(profiler, profile_dir)
                    profiler = None
                if pace_hz > 0 and len(self.kf_indices) > kfs_before:
                    budget = 1.0 / pace_hz - (time.perf_counter() - f_start)
                    if budget > 0.01:
                        time.sleep(budget)
                if progress and idx % 25 == 0:
                    Log(f"frame {idx}/{n} kfs={len(self.kf_indices)} gaussians={self.gmap.num_active}")
        finally:
            loader.close()
            if profiler is not None:
                self._stop_profiler(profiler, profile_dir)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        fps = (n - start) / wall

        results = {"fps": fps, "n_frames": n, "n_keyframes": len(self.kf_indices)}
        if self.do_color_refinement:
            self.color_refinement()
        if self.save_results:
            results["ate_rmse"] = eval_ate(
                self.frames, self.kf_indices, self.save_dir, n, final=True, monocular=self.monocular,
            )
            save_gaussians_ply(
                self.gmap, os.path.join(self.save_dir, "point_cloud", "final", "point_cloud.ply")
            )
        if self.do_eval_rendering:
            results.update(eval_rendering(
                self.gmap, self.frames, self.dataset, self.intr, self.rcfg,
                save_dir=self.save_dir if self.save_results else None, kf_indices=self.kf_indices,
            ))
        results["timers"] = self.timer.summary()
        Log(f"SLAM done: {fps:.2f} fps, {len(self.kf_indices)} keyframes", tag="Eval")
        return results
