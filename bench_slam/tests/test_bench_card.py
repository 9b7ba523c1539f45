"""On the card, at the cell's own size: sound runs of the cell are correct;
the control (the program's bfloat16 blend path, the lower precision the
check has to refuse) is not; and half the mapping cameras left out of the
loss, planted in the reference put in the program's place, reads above
the limits of the mapping numbers. Short windows that hold the first
keyframe mapping; the readings are printed (run with -s), and those that
set the limits are in PERF.md."""
import pytest
import torch

import cells
import check
import run
from reference import mapping as ref_mapping

SEEDS = (2**31 + 4242, 2**31 + 4243, 2**31 + 4244)
WINDOW = 8.0  # seconds: past the start of the window's first keyframe mapping


def _cell():
    return cells.find_cell("kitti07-seq")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _half_the_cameras_in_the_reference(monkeypatch) -> None:
    """Every other camera's render leaves the reference's mapping loss."""
    orig = ref_mapping.rasterize
    calls = {"n": 0}

    def rasterize(*args, **kw):
        out = orig(*args, **kw)
        calls["n"] += 1
        if calls["n"] % 2:
            return out._replace(image=out.image.detach() + 0.0 * out.image,
                                depth=out.depth.detach() + 0.0 * out.depth)
        return out
    monkeypatch.setattr(ref_mapping, "rasterize", rasterize)


def _fault_readings(snap: dict, frames: dict, monkeypatch) -> dict:
    """The mapping numbers of the reference with half its cameras, in the
    program's place, against the whole reference."""
    intr = check._dc(check.Intrinsics, snap["intr"])
    rcfg = check._dc(check.RenderConfig, snap["rcfg"])
    _l, g_ref, gt_ref = ref_mapping.first_iteration(snap, frames, intr, rcfg)
    with monkeypatch.context() as m:
        _half_the_cameras_in_the_reference(m)
        _l, g_bad, gt_bad = ref_mapping.first_iteration(snap, frames, intr, rcfg)
    moved_ref, moved_bad = ref_mapping.moved_poses(gt_ref, snap), ref_mapping.moved_poses(gt_bad, snap)

    def delta(moved):
        return {i: torch.cat([(Ra - Rb).reshape(-1), Ta - Tb]) for i, (Rb, Tb, Ra, Ta) in moved.items()}

    return {"map_grad": check.norm_gap(g_bad, g_ref, gate=g_ref),
            "map_pose_grad": check.norm_gap(gt_bad, gt_ref, gate=gt_ref),
            "map_pose_step": check.norm_gap(delta(moved_bad), delta(moved_ref),
                                            gate={i: gt_ref[i] for i in moved_ref})}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct_and_half_the_cameras_is_refused(card, monkeypatch, seed):
    kept = {}
    judge = check.judge

    def keep(capture, frames_of, limits):
        kept["map"], kept["frames"] = list(capture.map), dict(frames_of)
        return judge(capture, frames_of, limits)

    monkeypatch.setattr(check, "judge", keep)
    result, table = run.run_cell(_cell(), seed, WINDOW, False, "cuda")
    print(f"sound {seed}: {[(k, v) for k, v, _lim in table]}")
    bad = [_fault_readings(snap, kept["frames"], monkeypatch) for snap in kept["map"]]
    print(f"half the cameras {seed}: {bad}")
    assert result["correct"], table
    limits = _cell().limits
    assert bad and all(b["map_grad"] > limits["map_grad"] and b["map_pose_grad"] > limits["map_pose_grad"]
                       for b in bad)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_refused(card, seed):
    result, table = run.run_cell(_cell(), seed, WINDOW, False, "cuda", control="bf16")
    print(f"control {seed}: {[(k, v) for k, v, _lim in table]}")
    assert result["correct"] is False, table
