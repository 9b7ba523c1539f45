"""The masker's model hooks in lvdgs_torch against lvdgs_tpu's on the CPU:
GroundingDINO and SAM loaded by each package's build_masker from the same
tiny official-layout checkpoints (the reference's random weights, carried
over by lvdgs_torch.convert), run through the masking ladder on the same
frames give the same detections, segmentations and static masks, frame by
frame."""
import jax
import numpy as np
import pytest
import torch

from lvdgs_torch import convert
from lvdgs_torch.models.groundingdino import convert as tgconv
from lvdgs_torch.models.groundingdino import model as tgm
from lvdgs_torch.models.groundingdino.inference import GroundingDINODetector
from lvdgs_torch.models.sam import convert as tsconv
from lvdgs_torch.models.sam import model as tsm
from lvdgs_torch.perception import build_masker
from lvdgs_tpu.models.groundingdino import inference as jginf
from lvdgs_tpu.models.groundingdino import model as jgm
from lvdgs_tpu.models.sam import inference as jsinf
from lvdgs_tpu.models.sam import model as jsm
from lvdgs_tpu.perception import build_masker as jbuild

import torch_parity  # noqa: F401  (TF32 off, one intra-op thread)


def _frames(n=3, seed=5, H=48, W=64):
    """A textured frame with two blocks moving across it, (3, H, W) float."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.2, 0.8, size=(3, H, W)).astype(np.float32)
    out = []
    for i in range(n):
        img = base.copy()
        img[:, 20:34, 4 + 3 * i:20 + 3 * i] = 0.95
        img[:, 30:44, 44 - 2 * i:58 - 2 * i] = np.array([0.1, 0.7, 0.9], np.float32)[:, None, None]
        out.append(img)
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """TINY GroundingDINO and SAM from the reference's init, in the official
    layouts."""
    d = tmp_path_factory.mktemp("ckpt")
    gparams = jax.tree.map(np.asarray, jgm.init_params(jax.random.PRNGKey(2), jgm.TINY_GDINO))
    sparams = jax.tree.map(np.asarray, jsm.init_params(jax.random.PRNGKey(3), jsm.TINY))
    torch.save({"model": convert.groundingdino_state_dict_from_numpy(gparams, tgm.TINY_GDINO)}, d / "gd.pth")
    torch.save(convert.sam_state_dict_from_numpy(sparams, tsm.TINY), d / "sam.pth")
    return str(d / "gd.pth"), str(d / "sam.pth")


def test_masker_with_model_hooks_matches_reference(checkpoints, monkeypatch):
    """Both hooks through each package's build_masker (their default
    configs set to TINY), the flow on, the "parking" prompt (its
    packaged-vocab ids fit TINY_BERT's 128 rows); the detector is held at
    its raw outputs, the ladder at its masks."""
    monkeypatch.setattr(tgconv, "GroundingDINOConfig", lambda: tgm.TINY_GDINO)
    monkeypatch.setattr(tsconv, "SAMConfig", lambda: tsm.TINY)
    monkeypatch.setattr(jginf, "GroundingDINOConfig", lambda: jgm.TINY_GDINO)
    monkeypatch.setattr(jsinf, "SAMConfig", lambda: jsm.TINY)
    gd, sam = checkpoints
    cfg = {"dynamic_filtering": {"enabled": True, "scene_type": "parking", "use_flow": True,
                                 "grounding_dino_checkpoint": gd, "sam_checkpoint": sam}}
    ours, ref = build_masker(cfg, device="cpu"), jbuild(cfg)
    assert isinstance(ours.detector, GroundingDINODetector) and isinstance(ref.detector, jginf.GroundingDINODetector)
    assert ours.segmenter is not None and ref.segmenter is not None

    # the detector on the first frame, before thresholding
    img = ours._to_u8_hwc(_frames(1)[0])
    prompt = ours.prompt_manager.get_dynamic_prompt()
    tb, ts = ours.detector(img, prompt, box_threshold=0.0)
    jb, js = ref.detector(img, prompt, box_threshold=0.0)
    np.testing.assert_allclose(tb, jb, atol=1e-5 * np.abs(jb).max())
    np.testing.assert_allclose(ts, js, atol=1e-6)

    # the segmenter on the best three boxes: equal masks away from logits
    # within 1e-5 of the largest magnitude of 0
    top = np.argsort(-js)[:3]
    seg = ours.segmenter(img, tb[top])
    logits = ours.segmenter.mask_logits(img, tb[top]).numpy()
    near = np.abs(logits) <= 1e-5 * np.abs(logits).max()
    assert ((seg != ref.segmenter(img, jb[top])) & ~near).sum() == 0

    # the ladder on those boxes (random weights score most queries above
    # 0.35), with SAM's masks and with rectangles: the random masks cover
    # the frame and the failsafe rejects them, the rectangles do not
    ours.box_threshold = ref.box_threshold = float(js[top[-1]])
    for use_sam in (True, False):
        ours.use_sam = ref.use_sam = use_sam
        dynamic = []
        for i, f in enumerate(_frames()):
            mask = ours.get_static_mask(f, frame_idx=i)
            np.testing.assert_array_equal(mask, ref.get_static_mask(f, frame_idx=i),
                                          err_msg=f"use_sam {use_sam}, frame {i}")
            dynamic.append(float((~mask).mean()))
        assert (ours.saturated_frames > 0) if use_sam else (max(dynamic) > 0), (use_sam, dynamic)
