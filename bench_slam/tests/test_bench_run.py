"""A tiny run of the harness on the CPU: the shape of its result line, the
check's verdict on a sound run, and the check failing on each fault a
SLAM cell can have, planted under the timed path. The harness's look for
a card is skipped by calling `run_cell` with the CPU (the command itself
refuses without CUDA: last test)."""
import json
import subprocess
import sys

import pytest
import torch

import run
from tiny import tiny_cell

SEED = 2**31 + 77


def _run(seconds=6.0):
    result, table = run.run_cell(tiny_cell(), SEED, seconds, False, device="cpu")
    return result, {k: v for k, v, _lim in table}


def test_result_line_shape_and_a_sound_run_is_correct():
    result, readings = _run(seconds=14.0)
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {"fps", "pose_ms", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] == 1
    assert all(v is not None for v in readings.values()), readings
    assert result["correct"], result["checks"]
    json.dumps(result)


def _unchanged_tracking(monkeypatch):
    """Every tracking step returns the pose it was given."""
    import types

    from lvdgs_torch.slam import tracking

    monkeypatch.setattr(tracking, "lie", types.SimpleNamespace(apply_delta=lambda R, T, tau: (R, T)))


def _unchanged_map_step(monkeypatch):
    from lvdgs_torch.gaussian import model as gm

    monkeypatch.setattr(gm.MapOptimizer, "step", lambda self, gmap, grads, state, lr_step: None)


def _unchanged_window_poses(monkeypatch):
    """Mapping's pose updates return the pose they were given."""
    from lvdgs_torch.slam import mapping

    class Lie:
        def __getattr__(self, name):
            return getattr(orig, name)

        def apply_delta(self, R, T, tau):
            return (R, T) if not tau.requires_grad else orig.apply_delta(R, T, tau)

    orig = mapping.lie
    monkeypatch.setattr(mapping, "lie", Lie())


def _half_the_cameras(monkeypatch):
    from lvdgs_torch.slam import mapping

    orig = mapping.rasterize
    calls = {"n": 0}

    def rasterize(*args, **kw):
        out = orig(*args, **kw)
        calls["n"] += 1
        if calls["n"] % 2:
            # this camera's render leaves the loss (its graph stays, at
            # zero weight): the mean over the rest
            return out._replace(image=out.image.detach() + 0.0 * out.image,
                                depth=out.depth.detach() + 0.0 * out.depth)
        return out
    monkeypatch.setattr(mapping, "rasterize", rasterize)


def _altered_blend(monkeypatch):
    from lvdgs_torch.ops import rasterizer_cuda as rc

    orig = rc._packed_forward

    def _packed_forward(*args):
        acc, trans, nt, march = orig(*args)
        return acc * (1.0 + 1e-3), trans, nt, march
    monkeypatch.setattr(rc, "_packed_forward", _packed_forward)


@pytest.mark.parametrize("fault,fails", [
    (_unchanged_tracking, "track20_trans"),
    (_unchanged_map_step, "map_step"),
    (_unchanged_window_poses, "map_pose_step"),
    (_half_the_cameras, "map_grad"),
    (_half_the_cameras, "map_pose_grad"),
    (_altered_blend, "blend_fwd"),
])
def test_each_fault_makes_the_run_incorrect(monkeypatch, fault, fails):
    fault(monkeypatch)
    result, readings = _run()
    assert not result["correct"]
    assert readings[fails] > result["checks"][fails]["limit"], readings


def test_no_jax_in_the_process_and_names_compared_whole(monkeypatch):
    import lvdgs_torch.slam.system  # noqa: F401 - the program under test

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)  # shares a prefix, not the name
    monkeypatch.setitem(sys.modules, "lvdgs_tpu_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_the_command_refuses_without_enough_cards():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(run.HERE / "run.py"), "--workload", "kitti07-seq",
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3 and proc.stdout == ""
