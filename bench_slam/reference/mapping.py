"""The first iteration of a keyframe mapping run, in the benchmark's plain
reference: a frozen copy of the port's mapping loss (per camera
alpha * L1(exposure-compensated image) + (1 - alpha) * L1(depth against the
keyframe's mono depth), the replay keyframes drawn as the port draws them,
the isotropic regulariser), of its per-field Adam step with the 3DGS
position schedule, and of the window poses' first Adam step, rendered
through the plain reference of `render`.

It starts from the state the program held when the run began (the map, its
Adam moments, the keyframe poses, exposures and mono depths, the replay
generator's state): one iteration of the program is followed from the
program's own state. The keyframe images are the benchmark's own frames,
quantised to 8 bits as a keyframe stores them."""
from __future__ import annotations

import math

import torch

from . import lie
from .camera import Intrinsics
from .render import RenderConfig, prepare_bins, prepare_bins_with_touched, rasterize

PARAM_FIELDS = ("means", "features_dc", "log_scales", "quats", "logit_opacities")


def draw_replay(n_elig: int, generator: torch.Generator) -> tuple[int, int]:
    n = max(n_elig, 1)
    r1 = int(torch.randint(0, n, (), generator=generator))
    r2 = (r1 + 1 + int(torch.randint(0, max(n_elig - 1, 1), (), generator=generator))) % n
    return r1, r2


def isotropic_reg(scaling: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    dev = (scaling - scaling.mean(dim=1, keepdim=True)).abs()
    m = active.to(scaling.dtype)[:, None]
    return (dev * m).sum() / (m.sum() * scaling.shape[1] + 1e-8)


def position_lr(step: int, *, lr_init: float, lr_final: float, max_steps: int,
                spatial_scale: float) -> float:
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t) * spatial_scale


def quantise(image: torch.Tensor) -> torch.Tensor:
    """A frame as a keyframe stores it: 8 bits, read back in [0, 1]."""
    return torch.clamp(image * 255.0 + 0.5, 0, 255).to(torch.uint8).to(torch.float32) / 255.0


def first_iteration(snap: dict, frames: dict, intr: Intrinsics, rcfg: RenderConfig):
    """(loss, {field: gradient}, {window position: pose gradient}) of the
    run's first iteration. `snap` holds
    the state at the run's start (see the harness's capture); `frames`
    maps a frame index to the benchmark's image of it (3, H, W)."""
    m = snap["mcfg"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in snap["params"].items()}
    active = snap["active"]
    slots = snap["window_slots"]
    count = snap["kf_count"]
    M = snap["kf_R"].shape[0]
    valid_idx = [i for i, s in enumerate(slots) if s >= 0]
    safe = [min(max(s, 0), M - 1) for s in slots]
    in_window = {safe[i] for i in valid_idx}
    elig = [j for j in range(count) if j not in in_window]
    Nr = m["n_random"]
    gen = torch.Generator().set_state(snap["generator_state"])
    replay = []
    if Nr > 0:
        r1, r2 = draw_replay(len(elig), gen)
        replay = [elig[r] if r < len(elig) else 0 for r in (r1, r2)][:Nr]
    replay_w = [float(len(elig) > 0), float(len(elig) > 1)][:Nr]
    if not valid_idx or m["initialization"]:
        replay_w = [0.0] * Nr
    cams = [("w", safe[i]) for i in valid_idx] + [
        ("r", replay[r]) for r in range(len(replay)) if replay_w[r] > 0]
    weights = [1.0] * len(valid_idx) + [w for w in replay_w if w > 0]
    use_fb = rcfg.use_packed and rcfg.saturation_feedback
    dev = active.device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    taus = {}  # window position -> its pose delta, a zero that takes the gradient
    for k, ((kind, slot), weight) in enumerate(zip(cams, weights)):
        R, T = snap["kf_R"][slot], snap["kf_T"][slot]
        ab = snap["kf_ab"][slot]
        with torch.no_grad():
            p0 = {k: v.detach() for k, v in params.items()}
            if use_fb and kind == "w":
                bins, _vis = prepare_bins_with_touched(p0, active, R, T, intr, rcfg, margin=m["bin_margin"])
            else:
                bins = prepare_bins(p0, active, R, T, intr, rcfg, margin=m["bin_margin"])
        if kind == "w":
            tau = torch.zeros(6, dtype=torch.float32, device=dev, requires_grad=True)
            taus[valid_idx[k]] = tau
            R, T = lie.apply_delta(R, T, tau)
        image_gt = quantise(frames[snap["kf_frame"][slot]])
        mono = snap["kf_mono"][slot]
        mr = (image_gt.sum(0) > m["rgb_boundary_threshold"])[None].to(torch.float32)
        md = (mono > 0.01)[None].to(torch.float32)
        out = rasterize(params, active, R, T, intr, rcfg, bins)
        image = out.image if m["initialization"] else torch.exp(ab[0]) * out.image + ab[1]
        li = m["alpha"] * (image * mr - image_gt * mr).abs().mean() + (1 - m["alpha"]) * (
            out.depth * md - mono[None] * md).abs().mean()
        total = total + li * weight
    total = total + m["isotropic_weight"] * isotropic_reg(torch.exp(params["log_scales"]), active)
    order = list(taus)
    grads = torch.autograd.grad(total, [params[f] for f in PARAM_FIELDS] + [taus[i] for i in order])
    return (total.detach(), dict(zip(PARAM_FIELDS, grads[:len(PARAM_FIELDS)])),
            dict(zip(order, grads[len(PARAM_FIELDS):])))


def pose_mask(snap: dict) -> list:
    """The window positions whose pose the run refines: valid, not frame 0,
    among the first pose_window, with pose refinement on."""
    m, slots = snap["mcfg"], snap["window_slots"]
    M = snap["kf_R"].shape[0]
    out = []
    for i, s in enumerate(slots):
        frame = snap["kf_frame"][min(max(s, 0), M - 1)] if s >= 0 else None
        out.append(s >= 0 and frame != 0 and i < m["pose_window"] and m["up_pose"])
    return out


@torch.no_grad()
def moved_poses(g_tau: dict, snap: dict) -> dict:
    """{window position: (R, T before, R, T after)} of the refined window
    poses after the first iteration's Adam step (zero moments, one step,
    tau = (translation, rotation))."""
    m = snap["mcfg"]
    M = snap["kf_R"].shape[0]
    b1, b2, eps = m["b1"], m["b2"], m["adam_eps"]
    out = {}
    for i, refine in enumerate(pose_mask(snap)):
        if not refine:
            continue
        g = g_tau[i]
        lr = torch.tensor([m["lr_trans"]] * 3 + [m["lr_rot"]] * 3, dtype=torch.float32, device=g.device)
        mh = ((1 - b1) * g) / (1 - b1)
        vh = ((1 - b2) * g * g) / (1 - b2)
        tau = -(lr * mh / (torch.sqrt(vh) + eps))
        slot = min(max(snap["window_slots"][i], 0), M - 1)
        R, T = snap["kf_R"][slot], snap["kf_T"][slot]
        out[i] = (R, T, *lie.apply_delta(R, T, tau))
    return out


@torch.no_grad()
def adam_step(params: dict, grads: dict, m: dict, v: dict, count: int, active: torch.Tensor,
              lr_step: int, opt: dict) -> dict:
    """The map after one per-field Adam step on the active rows, from the
    moments `m`, `v` after `count` steps; returns the new parameters."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    count += 1
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    lrs = {
        "means": position_lr(lr_step, lr_init=opt["position_lr_init"], lr_final=opt["position_lr_final"],
                             max_steps=opt["position_lr_max_steps"], spatial_scale=opt["spatial_scale"]),
        "features_dc": opt["feature_lr"], "log_scales": opt["scaling_lr"],
        "quats": opt["rotation_lr"], "logit_opacities": opt["opacity_lr"],
    }
    out = {}
    for f in PARAM_FIELDS:
        g = grads[f]
        mask = active if g.dim() == 1 else active[:, None]
        g = torch.where(mask & torch.isfinite(g), g, torch.zeros_like(g))
        mf = b1 * m[f] + (1 - b1) * g
        vf = b2 * v[f] + (1 - b2) * g * g
        upd = lrs[f] * (mf / c1) / (torch.sqrt(vf / c2) + eps)
        out[f] = params[f] - torch.where(mask, upd, torch.zeros_like(upd))
    return out
