"""Whether what the window produced is correct: the program's outputs held
against the plain reference (`reference/`), number by number, each beside
its limit (`limits/<config>.json`).

The numbers (each the largest over the run's samples):
- track20_rot_rad, track20_trans: a tracked frame's pose after its first
  rebin period (20 iterations), against the reference's tracking of the
  same frame from the same seed pose over the same map (the map as the
  program held it); track_rot_rad, track_trans, track_expo: the pose and
  exposure the tracker returned after all its iterations, against the
  same;
- map_grad, map_step: the first iteration of a keyframe mapping run, from
  the state the program held when the run began: each map field's
  gradient norm, and the norm of its Adam step, against the reference's
  (the gap of the two norms over the larger of the reference's norm of
  that field and the median field's; fields whose reference gradient is
  under a thousandth of the median field's are left out);
- map_pose_grad, map_pose_step: the same iteration's window poses: each
  window camera's pose gradient norm, and the norm of each refined pose's
  change ([R | T] after its Adam step less before), against the
  reference's, measured as the map's fields are (each camera a leaf);
- blend_fwd, blend_bwd: packed blend forwards and backwards of the window
  against the plain blend on the same inputs (the largest gap of each
  output field over that field's largest value; a forward whose march
  lengths or touch counts differ reads 1)."""
from __future__ import annotations

import math

import torch

from reference import mapping as ref_mapping
from reference.blend import packed_blend_backward_plain, packed_blend_forward_plain
from reference.camera import Intrinsics
from reference.render import RenderConfig
from reference.tracking import TrackingConfig, TrackInput, track_camera

NUMBERS = ("track20_rot_rad", "track20_trans", "track_rot_rad", "track_trans", "track_expo",
           "map_grad", "map_step", "map_pose_grad", "map_pose_step", "blend_fwd", "blend_bwd")


def _dc(cls, d: dict):
    names = {f for f in cls.__dataclass_fields__}
    return cls(**{k: v for k, v in d.items() if k in names})


def rot_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> float:
    """The angle of Ra Rb^T, from the chord ||Ra - Rb||_F = 2 sqrt(2)
    sin(angle / 2) (arccos of the trace loses all digits near 0)."""
    chord = float(torch.linalg.norm(Ra.double() - Rb.double()))
    return 2.0 * math.asin(min(chord / (2.0 * math.sqrt(2.0)), 1.0))


def track_gaps(snap: dict) -> dict:
    cam = TrackInput(**snap["cam"])
    periods: list = []
    res = track_camera(snap["params"], snap["active"], cam, _dc(Intrinsics, snap["intr"]),
                       _dc(RenderConfig, snap["rcfg"]), _dc(TrackingConfig, snap["tcfg"]), periods)
    out = snap["out"]
    # the pose after the first rebin period (its first 20 iterations); a
    # tracker of one period has only its final pose
    (Rp, Tp), (Rr, Tr) = ((out["period_poses"][1], periods[1]) if len(periods) > 1
                          else ((out["R"], out["T"]), (res.R, res.T)))
    return {
        "track20_rot_rad": rot_angle(Rp, Rr),
        "track20_trans": float(torch.linalg.norm(Tp.double() - Tr.double())),
        "track_rot_rad": rot_angle(out["R"], res.R),
        "track_trans": float(torch.linalg.norm(out["T"].double() - res.T.double())),
        "track_expo": max(abs(float(out["exposure_a"] - res.exposure_a)),
                          abs(float(out["exposure_b"] - res.exposure_b))),
    }


def norm_gap(prog: dict, ref: dict, gate: dict | None = None) -> float:
    """Largest gap of per-field norms, each over the larger of the
    reference's norm of that field and the median field's; fields whose
    `gate` norm (the reference gradient's) is under a thousandth of the
    median field's are left out."""
    nr = {k: float(torch.linalg.norm(ref[k].double())) for k in ref}
    med = sorted(nr.values())[len(nr) // 2]
    if gate is not None:
        ng = {k: float(torch.linalg.norm(gate[k].double())) for k in gate}
        gmed = sorted(ng.values())[len(ng) // 2]
        keep = [k for k in ref if ng[k] >= 1e-3 * gmed]
    else:
        keep = list(ref)
    gaps = [abs(float(torch.linalg.norm(prog[k].double())) - nr[k]) / max(nr[k], med, 1e-30)
            for k in keep]
    return max(gaps) if gaps else 0.0


def map_gaps(snap: dict, frames: dict) -> dict:
    intr, rcfg = _dc(Intrinsics, snap["intr"]), _dc(RenderConfig, snap["rcfg"])
    _loss, g_ref, gt_ref = ref_mapping.first_iteration(snap, frames, intr, rcfg)
    st = snap["step"]
    g_prog = st["grads"]
    out = {"map_grad": norm_gap(g_prog, g_ref, gate=g_ref)}
    # the step: the reference's Adam from the moments the program's step saw
    new = ref_mapping.adam_step(st["params"], g_ref, st["m"], st["v"], st["count"], st["active"],
                                st["lr_step"], snap["opt"])
    d_prog = {k: st["after"][k] - st["params"][k] for k in new}
    d_ref = {k: new[k] - st["params"][k] for k in new}
    out["map_step"] = norm_gap(d_prog, d_ref, gate=g_ref)
    # the window poses: the program's pose gradients by window position,
    # and its pose updates, made in the order of the refined positions
    pose = snap["pose"]
    out["map_pose_grad"] = norm_gap({i: pose["g"][i] for i in gt_ref}, gt_ref, gate=gt_ref)
    moved = ref_mapping.moved_poses(gt_ref, snap)
    if len(pose["moves"]) != len(moved):
        out["map_pose_step"] = 1.0
    elif moved:
        d_prog = {i: torch.cat([(Ra - Rb).reshape(-1), Ta - Tb])
                  for i, (Rb, Tb, Ra, Ta) in zip(moved, pose["moves"])}
        d_ref = {i: torch.cat([(Ra - Rb).reshape(-1), Ta - Tb]) for i, (Rb, Tb, Ra, Ta) in moved.items()}
        out["map_pose_step"] = norm_gap(d_prog, d_ref, gate={i: gt_ref[i] for i in moved})
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / max(scale, 1e-30) if b.numel() else 0.0


def fwd_gap(snap: dict) -> float:
    tp, cg, k0, goff, tids = snap["args"]
    acc, trans, nt, march = packed_blend_forward_plain(tp, cg, k0, goff, tids, snap["n_groups"], snap["ntx"],
                                                       snap["with_nt"], probe_wmax=snap["probe_wmax"])
    p_acc, p_trans, p_nt, p_march = snap["out"]
    if not torch.equal(p_march, march) or ((snap["with_nt"] or snap["probe_wmax"]) and not torch.equal(p_nt, nt)):
        return 1.0
    return max(_rel(p_acc[:, :3], acc[:, :3]), _rel(p_acc[:, 3], acc[:, 3]), _rel(p_trans, trans))


def bwd_gap(snap: dict) -> float:
    tp, cg, k0, goff, tids, _march, acc, trans, dacc, dtrans = snap["args"]
    ref = packed_blend_backward_plain(tp, cg, k0, goff, tids, acc, trans, dacc, dtrans, snap["n_groups"],
                                      snap["ntx"])
    return max(_rel(snap["out"][..., f], ref[..., f]) for f in range(ref.shape[-1]))


def judge(capture, frames_of: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: (reading, limit)}) over the run's samples. A
    number with no sample in the run reads None and fails; a number the
    limits file leaves out is reported with the limit None and not
    compared."""
    readings: dict = {k: [] for k in NUMBERS}
    with torch.no_grad():
        for s in capture.fwd:
            readings["blend_fwd"].append(fwd_gap(s))
        for s in capture.bwd:
            readings["blend_bwd"].append(bwd_gap(s))
    for s in capture.track:
        for k, v in track_gaps(s).items():
            readings[k].append(v)
    for s in capture.map:
        for k, v in map_gaps(s, frames_of).items():
            if v is not None:
                readings[k].append(v)
    table = {}
    ok = True
    for k in NUMBERS:
        vals = readings[k]
        val = max(vals) if vals else None
        lim = float(limits[k]) if k in limits else None
        table[k] = (val, lim)
        if lim is not None:
            ok = ok and val is not None and math.isfinite(val) and val <= lim
    # the compared numbers last, so that they end standard error
    return ok, dict(sorted(table.items(), key=lambda kv: kv[1][1] is not None))
