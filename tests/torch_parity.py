"""Shared helpers of the lvdgs_torch parity tests: scenes made from a NumPy
seed, and conversions that hand the same arrays to both packages."""
import numpy as np
import pytest
import torch

# parity runs compare float32 math: no TF32 on the torch side (the JAX side
# runs matmuls at "highest" precision, tests/conftest.py)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the suite runs in several worker processes at once: one intra-op thread
# per core in each oversubscribes the cores tenfold, and the small tensors
# of these tests are no faster on several threads than on one
torch.set_num_threads(1)

PARAM_FIELDS = ("means", "features_dc", "log_scales", "quats", "logit_opacities")


def make_scene_np(n=80, seed=0, spread=1.2, depth=(2.0, 6.0)):
    """Random Gaussian scene in front of the identity camera (NumPy)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [rng.normal(size=(n, 2)) * spread, rng.uniform(depth[0], depth[1], size=(n, 1))], axis=1
    )
    return {
        "means": means.astype(np.float32),
        "features_dc": (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        "log_scales": rng.uniform(-2.5, -1.0, size=(n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.uniform(-1.0, 2.5, size=(n,)).astype(np.float32),
    }


def to_torch(d, requires_grad=False):
    return {k: torch.tensor(np.asarray(v), requires_grad=requires_grad) for k, v in d.items()}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def camera_pair(jcam, device="cpu"):
    """(JAX Camera, the same camera in lvdgs_torch), through convert.py."""
    from lvdgs_torch import convert

    return jcam, convert.camera_from_numpy(leaves_np(jcam), device)


def leaves_np(tree) -> dict:
    """A flax struct (GaussianMap, KeyframeBuffer, Camera) as NumPy arrays."""
    return {k: np.asarray(v) for k, v in vars(tree).items()}


def map_to_torch(jmap, jopt=None, device="cpu"):
    """The reference's GaussianMap (and AdamState) in lvdgs_torch."""
    from lvdgs_torch import convert

    gmap = convert.gaussian_map_from_numpy(leaves_np(jmap), device)
    if jopt is None:
        return gmap
    m = {k: np.asarray(v) for k, v in jopt.m.items()}
    v = {k: np.asarray(x) for k, x in jopt.v.items()}
    return gmap, convert.adam_state_from_numpy(m, v, np.asarray(jopt.count), device)


def assert_map_matches(tmap, jmap, atol=1e-6, topt=None, jopt=None, field_atol=None):
    """Slot-by-slot comparison of a map (and its Adam state): masks and
    integer fields exactly, float fields to `atol` (or `field_atol[name]`)."""
    from lvdgs_torch import convert

    tm = convert.gaussian_map_to_numpy(tmap)
    for k, ref in leaves_np(jmap).items():
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(tm[k], ref, err_msg=k)
        else:
            tol = (field_atol or {}).get(k, atol)
            np.testing.assert_allclose(tm[k], ref, atol=tol, rtol=1e-5, err_msg=k)
    if topt is not None:
        to = convert.adam_state_to_numpy(topt)
        assert to["count"] == int(np.asarray(jopt.count))
        for part in ("m", "v"):
            for k, ref in getattr(jopt, part).items():
                np.testing.assert_allclose(to[part][k], np.asarray(ref), atol=atol, rtol=1e-5,
                                           err_msg=f"{part}[{k}]")


def normalized_close(a, b, atol):
    """Compare two gradients after scaling both by the reference's max |.|."""
    a, b = to_np(a), to_np(b)
    denom = np.abs(a).max() + 1e-8
    np.testing.assert_allclose(b / denom, a / denom, atol=atol)


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels; skips where there is none
    (the kernels have no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")
