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

Dynamic scenes: a `masker` (``lvdgs_torch.perception``) gives each frame a
host-side static mask, sent to the device once per frame; it gates
seeding (dilated), the window cameras' mapping loss (`use_masked_loss`,
decided at construction as in the reference), the keyframe policy and the
static-region metrics. `save_state`/`load_state` write and read the
reference's resumable key set in one `torch.save` file, and
`run(checkpoint_every=N)` saves it every N frames.

Priors: `pose_prior(cam, last_kf_cam, slam)` seeds tracking, `depth_prior`
gives each frame's mono depth (with `wants_kf`, it also takes the last
keyframe's camera, so one fused MASt3R forward serves both) and
`scale_remedy(cam, last_kf_cam)` gives the fusion a scale where patch
alignment finds too few pixels (``lvdgs_torch.models.mast3r.inference``).
The tracking and mapping renders bin only the active prefix of the depth
sort (`_update_bin_bucket`, on by default off the CPU), and
`Results.global_BA` runs a photometric global bundle adjustment before
colour refinement.

Outputs that only read the state, as in the reference: `Results.use_gui`
feeds a `HeadlessViewer` (``lvdgs_torch.gui``) a packet after each tracked
frame (every `gui_every`-th is written), `Results.save_depth_comparison`
draws each fused keyframe's rendered against mono depth, and the final
eval writes each `viz_every`-th frame's render, depth and six-panel figure.

Configuration keys and defaults are those of the reference package.
Multi-device (`Performance.data_parallel`): one process per rank, each
building its SLAM with the same `mesh` (``lvdgs_torch.parallel``;
``python -m lvdgs_torch`` launches one rank per visible GPU). Tracking then
shards tile rows over the mesh's "data" ranks (track_camera_sharded) and
windowed mapping its cameras (mapping_run(mesh=...)); every rank holds a
replica of the map and takes the same host decisions, and rank 0 alone
writes results, the feed and checkpoints. Without a mesh it runs
single-device where one device of the SLAM's kind is visible, as the
reference does, and raises ValueError where more are.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import lie
from ..core.camera import Camera, Intrinsics
from ..core.config import DotDict
from ..core.log import Log, PhaseTimer, set_annotation, span, sync
from ..core.losses import compute_grad_mask
from ..data.datasets import load_dataset
from ..data.prefetch import PrefetchLoader
from ..eval.ate import eval_ate
from ..eval.rendering import eval_rendering
from ..gaussian import model as gm
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.ply import save_gaussians_ply
from ..parallel.mesh import dim_size
from ..ops.rasterizer import RenderConfig, rasterize_median_depth
from . import state as slam_state
from .depth_alignment import process_depth
from .keyframe import add_to_window, is_keyframe, visibility_pair_stats, visibility_window_stats
from .mapping import (
    MappingConfig, color_refine_run, covisibility_prune, covisibility_prune_from_occ, global_ba_run,
    mapping_run,
)
from .tracking import TrackingConfig, track_camera, track_camera_pyramid, track_camera_sharded


def resolve_device(device=None) -> torch.device:
    """The run's device: CUDA unless the caller asks for another. Raises
    when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _dilate_mask(mask: torch.Tensor, kernel: int) -> torch.Tensor:
    """Binary dilation by max-pooling with the reference's symmetric
    padding of kernel // 2 (an even kernel grows the mask by a row and a
    column, as the reference's reduce_window does)."""
    pad = kernel // 2
    return F.max_pool2d(mask.to(torch.float32)[None, None], kernel, stride=1, padding=pad)[0, 0] > 0.5


def _device_count(dev: torch.device) -> int:
    """Devices of `dev`'s kind that a data-parallel run would span."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _data_parallel_mesh(config: dict, dev: torch.device, mesh):
    """The mesh that tracking and mapping shard over, or None.

    Performance.data_parallel with a mesh of more than one "data" rank
    (every rank builds its SLAM with it): that mesh. Without a mesh, a
    run that sees one device of its kind runs single-device, as the
    reference does; one that sees more must be started one process per
    device, and is refused here rather than run on one of them."""
    dp = bool((config.get("Performance", {}) or {}).get("data_parallel", False))
    if mesh is not None:
        if not dp:
            raise ValueError("a mesh is used only with Performance.data_parallel: set it, or pass no mesh")
        n = dim_size(mesh, "data")
        if n == 1:
            return None
        Log(f"Camera-DP mapping and tile-sharded tracking over {n} ranks")
        return mesh
    if not dp:
        return None
    n = _device_count(dev)
    if n > 1:
        raise ValueError(
            f"Performance.data_parallel with {n} {dev.type} devices visible runs one process per device: "
            "start it with python -m lvdgs_torch (which launches the ranks), or build each rank's SLAM "
            "with a mesh from lvdgs_torch.parallel (launch.spawn, make_mesh)")
    Log(f"Performance.data_parallel with one {dev.type} device: running single-device")
    return None


class SLAM:
    """End-to-end monocular Gaussian-splatting SLAM."""

    def __init__(self, config: dict, save_dir: Optional[str] = None, device=None, masker=None,
                 pose_prior=None, depth_prior=None, scale_remedy=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = _data_parallel_mesh(config, self.device, mesh)
        # on a mesh, rank 0 alone writes results, the feed and checkpoints
        self.is_writer = mesh is None or torch.distributed.get_rank() == 0
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
        # active-prefix binning bucket (RenderConfig.bin_bucket) of those two
        # configs: binning costs what the depth-sorted candidate arrays hold,
        # and the map's capacity runs up to ~2.6x its active count, so the
        # host slices them to ~1.25x the actives in steps of
        # _bin_bucket_step (_update_bin_bucket). On by default off the CPU,
        # as in the reference; _bin_bucket_freeze holds the bucket where it
        # stands (for a timed window)
        self._bin_bucket_step = 16384
        self._bin_bucket_enable = perf.get("bin_active_bucket", not on_cpu)
        self._bin_bucket_freeze = False
        # synced_timers: end each timed phase with a device synchronise so
        # the phase timers read device time (costs one sync per phase)
        self.synced_timers = perf.get("synced_timers", False)
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
            # decided here, as in the reference: a masker assigned after
            # construction gates seeding and the metrics but not this loss
            use_masked_loss=masker is not None,
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
        self.save_results = res.get("save_results", True) and self.is_writer
        self.save_trj = res.get("save_trj", True)
        self.save_trj_kf_intv = res.get("save_trj_kf_intv", 10)
        self.do_color_refinement = res.get("color_refinement", True)
        self.color_refinement_iters = res.get("color_refinement_iters", 26000)
        self.do_eval_rendering = res.get("eval_rendering", True)
        # the eval's per-frame dumps and six-panel figures, every viz_every-th
        # frame (1 as in the reference; 0 writes none)
        self.eval_viz_every = res.get("viz_every", 1)
        self.do_global_ba = res.get("global_BA", False)
        self.global_ba_iters = tr.get("global_BA_itr_num", 500)
        # each fused keyframe's rendered against mono depth, drawn
        self.save_depth_comparison = res.get("save_depth_comparison", False) and self.is_writer
        # the headless GUI feed, every gui_every-th tracked frame written
        self.viewer = None
        if res.get("use_gui", False) and self.is_writer:
            from ..gui.gui_utils import HeadlessViewer

            self.viewer = HeadlessViewer(os.path.join(self.save_dir or ".", "gui"), every=res.get("gui_every", 5))
        # dynamic-object masker: get_static_mask(image (3, H, W) host array,
        # frame_idx) -> (H, W) bool host array, True = static
        self.masker = masker
        self._static_np: Dict[int, np.ndarray] = {}  # the last frame's host mask
        # prior plug points: pose_prior(cam, last_kf_cam, slam) -> (R, T)
        # seed or None; depth_prior(image) -> (H, W) mono depth (with
        # `wants_kf`, depth_prior(image, last_kf_cam=...)); scale_remedy(cam,
        # last_kf_cam) -> scale, asked when patch alignment degenerates
        self.pose_prior = pose_prior
        self.depth_prior = depth_prior
        self.scale_remedy = scale_remedy

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
        # the program's spans and counters; the sequence id is the rank
        # under a mesh
        self.timer = PhaseTimer(seq=0 if mesh is None else torch.distributed.get_rank())
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
            # the measurement's own wait, a span apart from the program's
            # `sync` reads
            self.timer.tic("phase_sync")
            torch.cuda.synchronize(self.device)
            self.timer.toc("phase_sync")

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
                # init mapping (one camera) runs on every rank alone
                mesh=None if mcfg.initialization else self.mesh,
            )
            self.iteration_count = res.iteration_count
            local_it += seg
            remaining -= seg
            # densification may approach the capacity ceiling mid-run (as in
            # the reference, the bucket is not refreshed here: ROADMAP C4)
            if remaining > 0 and self.gmap.capacity < self.max_capacity:
                if self.gmap.num_active > 0.7 * self.gmap.capacity:
                    self._grow_to(self.gmap.capacity * 2)
        return res

    def _store_frame_record(self, idx: int, packed: np.ndarray) -> None:
        # the frame's static mask, as the masker gave it on the host
        static = self._static_np.get(idx) if self.masker is not None else None
        self.frames[idx] = {
            "R": packed[0:9].reshape(3, 3),
            "T": packed[9:12],
            "R_gt": packed[12:21].reshape(3, 3),
            "T_gt": packed[21:24],
            "exposure_a": float(packed[24]),
            "exposure_b": float(packed[25]),
            "static_mask": static,
            "seq": self.timer.seq,
        }

    @staticmethod
    def _pose_record(cam: Camera) -> torch.Tensor:
        return torch.cat([
            cam.R.reshape(-1), cam.T, cam.R_gt.reshape(-1), cam.T_gt,
            torch.stack([cam.exposure_a, cam.exposure_b]),
        ])

    def _record_frame(self, idx: int, cam: Camera) -> None:
        rec = self._pose_record(cam)
        with sync():
            rec = rec.cpu().numpy()
        self._store_frame_record(idx, rec)

    def _mono_depth_for(self, image, depth, mono) -> torch.Tensor:
        """The frame's mono depth: from the depth prior where there is one
        (the reference takes it from MASt3R every frame), else per
        Dataset.mono_depth_source."""
        if self.depth_prior is not None:
            if getattr(self.depth_prior, "wants_kf", False):
                # the fused prior: one forward serves this depth and the
                # pose seed's pair, so it takes the last keyframe's camera
                last_kf_cam = self._cams.get(self.current_window[0]) if self.current_window else None
                prior = self.depth_prior(image, last_kf_cam=last_kf_cam)
            else:
                prior = self.depth_prior(image)
            return torch.as_tensor(np.asarray(prior), dtype=torch.float32, device=self.device)
        if self.mono_depth_source == "gt" and depth is not None:
            return torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        if mono is not None:
            return torch.as_tensor(mono, dtype=torch.float32, device=self.device)
        return torch.zeros((self.intr.height, self.intr.width), dtype=torch.float32, device=self.device)

    def _build_camera(self, idx: int, sample=None) -> Camera:
        image, depth, pose, mono = self.dataset[idx] if sample is None else sample
        f32 = dict(dtype=torch.float32, device=self.device)
        with sync():  # the frame's host arrays (the ground-truth pose) onto the device
            image_d = torch.as_tensor(image, **f32)
            gt_R = torch.as_tensor(np.asarray(pose[:3, :3]), **f32)
            gt_T = torch.as_tensor(np.asarray(pose[:3, 3]), **f32)
            depth_d = None if depth is None else torch.as_tensor(depth, **f32)
        cam = Camera.create(idx, image_d, self.intr, gt_R=gt_R, gt_T=gt_T, depth=depth_d)
        cam = cam.replace(
            mono_depth=self._mono_depth_for(image, depth, mono),
            grad_mask=compute_grad_mask(
                cam.image,
                self.config["Training"].get("edge_threshold", 1.1),
                self.config["Dataset"].get("type", "KITTI"),
            ),
        )
        if self.masker is not None:
            with span("mask"):
                # a masker with its own host-side images (IntervalMasker with
                # an image_provider) skips the frame's transfer to the host
                img_np = None
                if not getattr(self.masker, "provides_images", False):
                    with sync():
                        img_np = cam.image.cpu().numpy()
                static = np.asarray(self.masker.get_static_mask(img_np, frame_idx=idx), bool)
                self._static_np = {idx: static}
                with sync():
                    static_dev = torch.as_tensor(static, device=self.device)
                cam = cam.replace(static_mask=static_dev, has_static_mask=True)
        return cam

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
        ratio = rd / torch.clamp(gd, min=1e-6)
        with sync():  # the masked pixels' count
            ratio = ratio[ok]
        ratio = torch.sort(ratio).values
        n = ratio.numel()
        med = 0.5 * (ratio[(n - 1) // 2] + ratio[n // 2]) if n else torch.tensor(float("nan"))
        with sync():
            med = float(med)
        if n >= 100 and np.isfinite(med):
            self._map_scale_obs = med
            self._scale_history.append((int(cam.uid), med))
            if len(self._scale_history) > 4096:
                del self._scale_history[:-4096]

    def _pose_seed(self, idx: int, cam: Camera) -> Camera:
        f32 = dict(dtype=torch.float32, device=self.device)
        if self.pose_prior is not None:
            last_cam = self._cams.get(self.current_window[0])
            seed = self.pose_prior(cam, last_cam, self)
            if seed is not None:
                with sync():
                    R, T = (torch.as_tensor(np.asarray(x), **f32) for x in seed)
                return cam.update_RT(R, T)
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
                with sync():
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
                with sync():
                    R_seed, T_seed = torch.as_tensor(R_seed, **f32), torch.as_tensor(T_seed, **f32)
                return cam.update_RT(R_seed, T_seed)
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
            R, T = seed[:3, :3], seed[:3, 3]
        else:
            R, T = prev["R"], prev["T"]
        with sync():
            R, T = torch.as_tensor(R, **f32), torch.as_tensor(T, **f32)
        return cam.update_RT(R, T)

    # ----------------------------------------------------------- keyframe add

    @torch.no_grad()
    def _fused_keyframe_depth(self, idx: int, cam: Camera, render_depth, init: bool):
        """Valid-RGB masking, mono depth for init, patch-based scale
        alignment against the rendered depth otherwise (with the mono-scale
        anchor and optional gauge servo). Returns (depth for seeding, cam
        with rescaled mono_depth)."""
        rgb_thr = self.config["Training"].get("rgb_boundary_threshold", 0.01)
        valid_rgb = cam.image.sum(dim=0) > rgb_thr
        if self.masker is not None and cam.has_static_mask:
            # seed only away from dynamic objects: the original's kernels
            # (9 on the first frame, 7 after) suit KITTI-size frames, and
            # Training.mask_dilation rescales them for small ones
            base = self.config["Training"].get("mask_dilation", 7)
            expanded_dynamic = _dilate_mask(~cam.static_mask, base + 2 if idx == 0 else base)
            valid_rgb = valid_rgb & ~expanded_dynamic
            # the original's graded static-region warnings (keyframes only)
            ratio = float((~expanded_dynamic).to(torch.float32).mean())
            if idx == 0 and ratio < 0.15:
                Log(f"CRITICAL: first-frame static region only {ratio:.1%} — initialization will "
                    "suffer; check scene_type / confidence threshold / mask expansion")
            if ratio < 0.2:
                Log(f"WARNING: expanded static region only {ratio:.1%} — reconstruction quality at "
                    "risk; consider reducing mask expansion or adjusting scene prompts")
            elif ratio < 0.4:
                Log(f"CAUTION: limited static region {ratio:.1%} — tracking may be less stable")
        if init or render_depth is None:
            return torch.where(valid_rgb, cam.mono_depth, torch.zeros_like(cam.mono_depth)), cam

        # the scale remedy, where patch alignment finds too few accurate
        # pixels, over the newest window keyframe, as in the reference
        remedy_fn = None
        if self.scale_remedy is not None and self.current_window:
            last_cam = self._cams.get(self.current_window[0])
            if last_cam is not None:
                remedy_fn = lambda: self.scale_remedy(cam, last_cam)  # noqa: E731

        if self.save_depth_comparison and self.save_dir:
            try:
                from ..eval.viz import save_depth_comparison

                save_depth_comparison(render_depth, cam.mono_depth, cam.image, idx,
                                      os.path.join(self.save_dir, "depth_comparison"))
            except Exception as e:  # the figure is best-effort
                Log(f"depth-comparison viz failed for frame {idx}: {e}")

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
            remedy_fn=remedy_fn,
        )
        with sync():
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

    def _update_bin_bucket(self, lower_bound: int = 0) -> None:
        """Re-bucket the tracking and mapping renders' binning
        (RenderConfig.bin_bucket) to the live active count: grow at once to
        at least 1.25x the bound, so that a seeding or densify burst cannot
        outrun it within a run; shrink only with two full steps of slack.
        0 bins at full capacity, where the bucket would save nothing. The
        exact renders keep full binning."""
        if not self._bin_bucket_enable or self._bin_bucket_freeze:
            return
        step = self._bin_bucket_step
        cap = self.gmap.capacity
        lb = max(self._num_active_cached(), lower_bound)
        desired = -(-int(lb * 1.25) // step) * step
        if desired >= cap - step // 2:
            desired = 0
        cur = self.rcfg_map.bin_bucket
        cur_eff = cur if cur else cap
        des_eff = desired if desired else cap
        if des_eff > cur_eff or des_eff <= cur_eff - 2 * step or (cur and cur > cap):
            self.rcfg_track = dataclasses.replace(self.rcfg_track, bin_bucket=desired)
            self.rcfg_map = dataclasses.replace(self.rcfg_map, bin_bucket=desired)

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
        # the seeding about to run can take the actives up to `need`: the
        # bucket covers it before the next tracking or mapping render
        self._update_bin_bucket(lower_bound=need)

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
        with span("seed.capacity"):
            self._ensure_capacity(self.pcd_downsample)
        self._cached_num_active = None
        with span("seed.points"):
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
        with span("prune.covis"):
            occ, self.initialized = self._prune(window_slots, res)
            for i, kf_idx in enumerate(self.current_window):
                self.occ_visibility[kf_idx] = occ[i]
        with span("prune.state"):
            self._sync_backend()
            self._maybe_shrink()
            self._update_bin_bucket()
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
        ], dim=1)
        with sync():
            packed = packed.cpu().numpy()
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
        with span("track.seed"):
            cam = self._pose_seed(idx, cam)
        if self.mesh is not None:
            # tile rows over the ranks, all-reduced pose gradients; ahead
            # of the pyramid, as in the reference
            res = track_camera_sharded(self.gmap.params(), self.gmap.active, cam, self.intr,
                                       self.rcfg_track, self.tcfg, self.mesh)
        else:
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
        ])
        with sync():
            packed = packed.cpu().numpy()
        pose_out = time.perf_counter()
        self._store_frame_record(idx, packed)
        self.frames[idx].update(iterations=int(res.iterations), pose_out=pose_out)
        self.timer.count("track.iterations", int(res.iterations))
        self.median_depth = float(packed[26])
        self._last_track_stats = packed[27:31].astype(np.int64)
        self._last_curr_vis = curr_vis
        return cam, res

    def _make_keyframe(self, idx: int, cam: Camera, track_res, curr_vis) -> None:
        if self.current_window:
            occ_stack = torch.stack([self.occ_visibility[k] for k in self.current_window])
            wstats = visibility_window_stats(curr_vis, occ_stack)
            with sync():
                wstats = wstats.cpu().numpy()
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

        # keyframe mask overlay dump
        if (self.masker is not None and getattr(self.masker, "save_images", False) and cam.has_static_mask
                and self.is_writer):
            self.masker.save_keyframe_overlay(cam.image, cam.static_mask, idx)

        self.timer.tic("kf_fusion")
        with span("fusion.depth"):
            render_depth = track_res.depth[0]
            if self.depth_fusion_source == "median":
                md, _mo = rasterize_median_depth(
                    self.gmap.params(), self.gmap.active, cam.R, cam.T, self.intr, self.rcfg
                )
                render_depth = md[0]
            if self.pose_seed_mode == "sim_prior" or self.scale_telemetry:
                self._observe_map_scale(render_depth, cam)
        with span("fusion.align"):
            depth, cam = self._fused_keyframe_depth(idx, cam, render_depth, init=False)
        self._phase_sync()
        self.timer.toc("kf_fusion")
        self._cams[idx] = cam
        self.kf_indices.append(idx)
        self.kf_slots[idx] = slam_state.add_keyframe(self.kfbuf, cam)
        self._backend_keyframe(idx, depth)

    def process_frame(self, idx: int, sample=None) -> None:
        """Track frame `idx` (or initialise on it) and, where the policy
        says so, make it a keyframe and map; all of it inside the span
        `frame`, with this SLAM's timer the thread's recorder."""
        with self.timer.activate(frame=idx):
            self.timer.tic("frame")
            try:
                self._process_frame(idx, sample)
            finally:
                self.timer.toc("frame")

    def _process_frame(self, idx: int, sample) -> None:
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
        static = self._static_np.get(idx) if self.masker is not None else None
        static_ratio = None if static is None else float(np.mean(static, dtype=np.float32))
        create_kf = is_keyframe(
            curr_R=self.frames[idx]["R"], curr_T=self.frames[idx]["T"],
            last_kf_R=self.frames[last_kf_idx]["R"], last_kf_T=self.frames[last_kf_idx]["T"],
            median_depth=self.median_depth, curr_visibility=curr_vis,
            last_kf_visibility=self.occ_visibility[last_kf_idx],
            kf_translation=self.kf_translation, kf_min_translation=self.kf_min_translation,
            kf_overlap=self.kf_overlap, static_ratio=static_ratio, overlap_stats=stats,
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

        if self.viewer is not None:
            self._feed_viewer(idx, res, create_kf)

        if self.save_results and self.save_trj and create_kf and \
                len(self.kf_indices) % self.save_trj_kf_intv == 0:
            eval_ate(self.frames, self.kf_indices, self.save_dir, idx, monocular=self.monocular)

    def _feed_viewer(self, idx: int, res, create_kf: bool) -> None:
        """The GUI packet of a tracked frame: its pose and render, the
        window's keyframes and, on a keyframe, the map's snapshot."""
        from ..gui.gui_utils import GaussianPacket, snapshot_gaussians

        pose = lambda k: {"R": self.frames[k]["R"], "T": self.frames[k]["T"], "uid": k}  # noqa: E731
        self.viewer.put(GaussianPacket(
            gaussians=snapshot_gaussians(self.gmap) if create_kf else None,
            current_frame=pose(idx),
            render=res.image.detach().cpu().numpy(),
            keyframes=[pose(k) for k in self.current_window],
            kf_window={self.current_window[0]: self.current_window[1:]} if self.current_window else None,
        ))

    # ------------------------------------------------------------- checkpoint

    def save_state(self, path: str) -> None:
        """Write the resumable state to the file `path`: the reference's key
        set (the map, its Adam state, the keyframe buffer, the frame records
        with their static masks, the window and visibility, the loop's
        counters and the scale observations), with this SLAM's generator
        state where the reference saves its JAX key. The keyframe buffer
        goes in as its filled rows; the rows past `count` hold the buffer's
        initial values and are made anew on load. On a mesh, rank 0 writes
        and the others return at once (a rank that then reads the file
        waits for it, e.g. at a barrier); every rank can load it."""
        if not self.is_writer:
            return
        kb = self.kfbuf
        n = kb.count
        save_checkpoint(path, {
            "gmap": {f.name: getattr(self.gmap, f.name) for f in dataclasses.fields(self.gmap)},
            "opt_state": {"m": dict(self.opt_state.m), "v": dict(self.opt_state.v),
                          "count": int(self.opt_state.count)},
            "kfbuf": {**{f.name: getattr(kb, f.name)[:n].clone() for f in dataclasses.fields(kb)
                         if f.name != "count"}, "count": n, "capacity": kb.capacity},
            "frames": {int(i): dict(f) for i, f in self.frames.items()},
            "kf_indices": [int(i) for i in self.kf_indices],
            "kf_slots": {int(k): int(v) for k, v in self.kf_slots.items()},
            "current_window": [int(i) for i in self.current_window],
            "occ_visibility": {int(k): v.clone() for k, v in self.occ_visibility.items()},
            "initialized": bool(self.initialized),
            "iteration_count": int(self.iteration_count),
            "median_depth": float(self.median_depth),
            "frames_processed": int(self.frames_processed),
            "rng": self.generator.get_state(),
            "idle_debt": int(self.idle_debt),
            "last_sent": int(self.last_sent),
            "anchor_scales": [float(x) for x in self._anchor_scales],
            "mono_anchor_val": None if self._mono_anchor_val is None else float(self._mono_anchor_val),
            "map_scale_obs": None if self._map_scale_obs is None else float(self._map_scale_obs),
            "scale_history": [(int(f), float(v)) for f, v in self._scale_history],
        })

    def load_state(self, path: str) -> None:
        """Restore what `save_state` wrote, onto this SLAM's device.
        Checkpoints without the optional keys (idle_debt, last_sent and
        the scale observations) take the reference's defaults. As in the
        reference, the frame loop's per-frame scratch (`_last_resize_kf`,
        `_servo_obs`, `_cams`) and the masker's history are not part of the
        state (ROADMAP C9)."""
        st = load_checkpoint(path, map_location=self.device)
        self.gmap = gm.GaussianMap(**st["gmap"])
        so = st["opt_state"]
        self.opt_state = gm.AdamState(m=dict(so["m"]), v=dict(so["v"]), count=int(so["count"]))
        kb = st["kfbuf"]
        buf = slam_state.create_keyframe_buffer(int(kb["capacity"]), self.intr.height, self.intr.width,
                                                self.device)
        n = int(kb["count"])
        for f in dataclasses.fields(buf):
            if f.name != "count":
                getattr(buf, f.name)[:n] = kb[f.name]
        buf.count = n
        self.kfbuf = buf
        self.frames = {
            int(i): {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in f.items()}
            for i, f in st["frames"].items()
        }
        self.kf_indices = [int(i) for i in st["kf_indices"]]
        self.kf_slots = {int(k): int(v) for k, v in st["kf_slots"].items()}
        self.current_window = [int(i) for i in st["current_window"]]
        self.occ_visibility = {int(k): v for k, v in st["occ_visibility"].items()}
        self.initialized = bool(st["initialized"])
        self.iteration_count = int(st["iteration_count"])
        self.median_depth = float(st["median_depth"])
        self.frames_processed = int(st["frames_processed"])
        self.generator.set_state(st["rng"].cpu())
        self.idle_debt = int(st.get("idle_debt", 0))
        self.last_sent = int(st.get("last_sent", 0))
        self._anchor_scales = [float(x) for x in st.get("anchor_scales", [])]
        mav = st.get("mono_anchor_val")
        self._mono_anchor_val = None if mav is None else float(mav)
        mso = st.get("map_scale_obs")
        self._map_scale_obs = None if mso is None else float(mso)
        self._scale_history = [(int(f), float(v)) for f, v in st.get("scale_history", [])]
        self._cached_num_active = None  # the restored map invalidates the cache

    def _start_profiler(self, profile_dir: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts,
                                      on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))
        prof.start()
        # the spans as named ranges over their kernels, in this trace only
        set_annotation(True)
        return prof

    def _stop_profiler(self, prof, profile_dir: str) -> None:
        set_annotation(False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        Log(f"profiler trace written to {profile_dir}")

    def global_ba(self, iters: Optional[int] = None) -> None:
        """Photometric global bundle adjustment over all stored keyframes
        (global_ba_run), then the keyframe poses into the frame records."""
        iters = iters or self.global_ba_iters
        Log(f"Starting global BA ({iters} iters)")
        with self.timer.activate():
            global_ba_run(
                self.gmap, self.opt_state, self.kfbuf, self.generator, iters, 0,
                intr=self.intr, rcfg=self.rcfg_map, opt=self.opt, mcfg=self.mcfg,
            )
            self._sync_backend()
            with sync():
                R, T = self.kfbuf.R.cpu().numpy(), self.kfbuf.T.cpu().numpy()
        for kf_idx, slot in self.kf_slots.items():
            self.frames[kf_idx]["R"] = R[slot]
            self.frames[kf_idx]["T"] = T[slot]
        Log("Global BA done")

    def color_refinement(self, iters: Optional[int] = None,
                         features_only: Optional[bool] = None) -> None:
        iters = iters or self.color_refinement_iters
        if features_only is None:
            features_only = self.config.get("Results", {}).get("refine_features_only", False)
        Log(f"Starting color refinement ({iters} iters{', features-only' if features_only else ''})")
        with self.timer.activate():
            color_refine_run(
                self.gmap, self.opt_state, self.kfbuf, self.generator, iters, 0,
                intr=self.intr, rcfg=self.rcfg_map, opt=self.opt, mcfg=self.mcfg,
                features_only=bool(features_only),
            )
        self._nan_scan(f"color_refine[{iters}]")
        Log("Map refinement done")

    def run(self, n_frames: Optional[int] = None, progress: bool = True,
            checkpoint_every: Optional[int] = None) -> dict:
        """Process frames from `frames_processed` (0, or where a loaded state
        stopped) to `n_frames`, then colour refinement and the evaluation.
        With `checkpoint_every`, the state is saved to
        <save_dir>/checkpoint after every frame whose index + 1 is a
        multiple of it. fps counts the frames this call processed."""
        n = len(self.dataset) if n_frames is None else min(n_frames, len(self.dataset))
        start = self.frames_processed
        loader = PrefetchLoader(self.dataset, depth=4, start=start, end=n)
        # optional torch.profiler trace of the loop from frame start +
        # profile_after for profile_frames more frames, written into
        # profile_dir (TensorBoard's and Chrome's trace format)
        res = self.config.get("Results", {})
        profile_dir = res.get("profile_dir") if self.is_writer else None
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
                if checkpoint_every and (idx + 1) % checkpoint_every == 0:
                    self.save_state(os.path.join(self.save_dir, "checkpoint"))
        finally:
            loader.close()
            if profiler is not None:
                self._stop_profiler(profiler, profile_dir)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        fps = (n - start) / wall

        results = {"fps": fps, "n_frames": n, "n_keyframes": len(self.kf_indices)}
        if self.do_global_ba:
            self.global_ba()
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
                viz_every=self.eval_viz_every,
            ))
        results["timers"] = self.timer.summary()
        if self.viewer is not None:
            self.viewer.close()
        Log(f"SLAM done: {fps:.2f} fps, {len(self.kf_indices)} keyframes", tag="Eval")
        return results
