"""The port's DINOv2 (lvdgs_torch/models/dinov2) against the reference's
dinov2_forward on the same NumPy weights and images.

Tolerances: the position-embedding resize within 4e-6 of
jax.image.resize(..., "bicubic") on unit-normal inputs (the weight
matrices are equal bit for bit; the reference's own float32 contraction
lies up to 3.1e-6 from the exact float64 one at 37x37 -> 26x87, the port's
within 4e-7); every block's tokens and attention maps and the final
tokens within 1e-5 absolute (float32 with TF32 off through 2 blocks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one thread, no TF32)
from lvdgs_torch import convert
from lvdgs_torch.models import dinov2 as td
from lvdgs_torch.models.dinov2.model import resize_pos_embed
from lvdgs_torch.models.mast3r.dpt import _axis_weights
from lvdgs_tpu.models.dinov2 import model as jd


def _pair(cfg, seed=0):
    params = jd.init_params(jax.random.PRNGKey(seed), cfg)
    np_params = jax.tree.map(np.asarray, params)
    model = td.DINOv2(cfg)
    model.load_state_dict(convert.dinov2_state_dict_from_numpy(np_params, cfg), strict=True)
    return params, model.eval()


@pytest.mark.parametrize("g,hw", [(8, (5, 11)), (6, (6, 6)), (37, (26, 87))])
def test_pos_embed_resize_matches_jax_bicubic(g, hw):
    """A non-square target that upsamples one axis and downsamples the
    other, the identity, and the street frame's 26x87 from the default
    37x37 grid."""
    x = np.random.default_rng(0).normal(size=(1, g, g, 16)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, *hw, 16), "bicubic"))
    ours = resize_pos_embed(torch.as_tensor(x), hw).numpy()
    np.testing.assert_allclose(ours, ref, atol=4e-6)
    exact = np.einsum("bhwd,hy,wx->byxd", x.astype(np.float64),
                      *(np.asarray(_axis_weights(a, b, "cpu", "bicubic"), np.float64)
                        for a, b in ((g, hw[0]), (g, hw[1]))))
    np.testing.assert_allclose(ours, exact, atol=1e-6)
    # torch's own bicubic (a = -0.75, clamped edges) is not this resize
    theirs = torch.nn.functional.interpolate(torch.as_tensor(x).permute(0, 3, 1, 2), size=hw, mode="bicubic",
                                             align_corners=False).permute(0, 2, 3, 1).numpy()
    if hw != (g, g):
        assert np.abs(theirs - ref).max() > 1e-3


@pytest.mark.parametrize("hw", [(64, 64), (40, 96)])
def test_tiny_forward_matches_reference(hw):
    """TINY_DINO at its position grid (8x8 patches) and on a 5x12 grid,
    which resizes the position embedding down on one axis and up on the
    other: every block's tokens and attention, the final tokens."""
    cfg = td.TINY_DINO
    params, model = _pair(cfg)
    img = np.random.default_rng(1).normal(size=(2, 3, *hw)).astype(np.float32)
    ref = jd.dinov2_forward(params, jnp.asarray(img), cfg)
    ours = td.dinov2_forward(model, torch.as_tensor(img))
    assert ours["grid"] == tuple(ref["grid"]) == (hw[0] // 8, hw[1] // 8)
    assert len(ours["tokens"]) == len(ours["attn"]) == cfg.depth
    for name in ("tokens", "attn"):
        for i, (a, b) in enumerate(zip(ours[name], ref[name])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=f"{name}[{i}]")
    np.testing.assert_allclose(ours["final"].numpy(), np.asarray(ref["final"]), atol=1e-5)


def test_hub_state_dict_loads_strictly_after_the_listed_cuts(tmp_path):
    """A hub-layout file (the port's state dict plus the hub's mask_token)
    loads strictly through load_hub, bare or under "model"; an unknown key
    or a missing one refuses; the reference's own converter reads the same
    file into the same forward."""
    cfg = td.TINY_DINO
    model = td.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    hub = dict(model.state_dict())
    hub["mask_token"] = torch.zeros(1, cfg.dim)
    path = str(tmp_path / "dinov2_tiny.pth")
    torch.save(hub, path)
    loaded = td.load_hub(path, cfg, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    td.load_hub({"model": hub}, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="Unexpected"):
        td.load_hub({**hub, "register_tokens": torch.zeros(1, 4, cfg.dim)}, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="Missing"):
        td.load_hub({k: v for k, v in hub.items() if k != "norm.bias"}, cfg, device="cpu")

    params = jd.convert_state_dict(hub, cfg)
    img = np.random.default_rng(2).normal(size=(1, 3, 32, 40)).astype(np.float32)
    ref = jd.dinov2_forward(params, jnp.asarray(img), cfg)
    ours = td.dinov2_forward(loaded, torch.as_tensor(img))
    np.testing.assert_allclose(ours["final"].numpy(), np.asarray(ref["final"]), atol=1e-5)


def test_numpy_converter_round_trips_the_reference_params():
    """convert.dinov2_state_dict_from_numpy is the inverse of the
    reference's convert_state_dict: its output read back by the reference
    gives the original parameters exactly."""
    cfg = td.TINY_DINO
    params = jax.tree.map(np.asarray, jd.init_params(jax.random.PRNGKey(3), cfg))
    sd = convert.dinov2_state_dict_from_numpy(params, cfg)
    assert set(sd) == set(td.DINOv2(cfg).state_dict())
    back = jd.convert_state_dict(sd, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_default_config_is_vit_b14():
    with torch.device("meta"):
        model = td.DINOv2()
    assert sum(p.numel() for p in model.parameters()) == 86579712
    assert td.DINOv2Config().patch_size == 14 and td.DINOv2Config().pos_grid == 37
