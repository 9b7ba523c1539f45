"""lvdgs_torch.perception against lvdgs_tpu.perception on the CPU: the
masking ladder on the same frames in both packages gives the same masks
(boxes -> masks, segmenter fusion, flow, temporal median, the
hallucination failsafe, the first-frame heuristic, ground segmentation,
shadow repair, the IntervalMasker cadence, the oracle hooks), plus port
copies of the reference's masker tests. Both ladders are host-side NumPy
and OpenCV, so every mask is compared for equality."""
import numpy as np
import pytest
import torch

from lvdgs_tpu.perception import build_masker as jbuild
from lvdgs_tpu.perception import masking as jm
from lvdgs_tpu.perception import oracle as jo
from lvdgs_torch.perception import build_masker
from lvdgs_torch.perception import masking as tm
from lvdgs_torch.perception import oracle as to


def _frames(n=6, seed=5, H=48, W=64):
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


class _Det:
    """A fixed-box detector; `boxes` per call index (cycled)."""

    def __init__(self, boxes, scores):
        self.boxes, self.scores, self.n = boxes, scores, 0

    def __call__(self, img, prompt):
        b = self.boxes[self.n % len(self.boxes)]
        s = self.scores[self.n % len(self.scores)]
        self.n += 1
        return np.asarray(b, np.float32), np.asarray(s, np.float32)


def _seg(img, boxes):
    """A segmenter that keeps the box's left half."""
    H, W = img.shape[:2]
    out = np.zeros((len(boxes), H, W), bool)
    for i, (x0, y0, x1, y1) in enumerate(np.asarray(boxes).astype(int)):
        out[i, max(y0, 0):min(y1, H), max(x0, 0):min(x1, W) - (x1 - x0) // 2] = True
    return out


LADDERS = {
    "boxes, flow": dict(make=lambda: _Det([[[4, 18, 24, 36], [40, 28, 60, 46]]], [[0.9, 0.8]]),
                        seg=False, kw=dict(use_flow=True)),
    "boxes, segmenter, flow": dict(make=lambda: _Det([[[4, 18, 24, 36], [40, 28, 60, 46]]], [[0.9, 0.8]]),
                                   seg=True, kw=dict(use_flow=True)),
    "scores below the threshold": dict(make=lambda: _Det([[[4, 18, 24, 36]]], [[0.2]]), seg=False,
                                       kw=dict(use_flow=False)),
    # a box every other frame: the temporal median votes it in and out
    "temporal median": dict(make=lambda: _Det([[[4, 18, 30, 40]], np.zeros((0, 4))], [[0.9], []]),
                            seg=False, kw=dict(use_flow=False, temporal_window=5)),
    # a detector claiming 80% of the frame: rejected before the median
    "failsafe": dict(make=lambda: _Det([[[0, 0, 64, 40]]], [[0.95]]), seg=False,
                     kw=dict(use_flow=False, max_dynamic_ratio=0.7)),
    "no detector: flow and the first-frame heuristic": dict(make=lambda: None, seg=False,
                                                           kw=dict(use_flow=True)),
    "ground segmentation": dict(make=lambda: _Det([[[10, 30, 60, 47]]], [[0.9]]), seg=False,
                                kw=dict(use_flow=False, use_ground_segmentation=True)),
}


@pytest.mark.parametrize("case", list(LADDERS))
def test_ladder_masks_match_reference(case):
    spec = LADDERS[case]
    masks = []
    for mod in (jm, tm):
        det = spec["make"]()
        m = mod.DynamicObjectMasker(detector=det, segmenter=_seg if spec["seg"] else None,
                                    use_sam=spec["seg"], **spec["kw"])
        masks.append([m.get_static_mask(f, frame_idx=i) for i, f in enumerate(_frames())])
    for i, (a, b) in enumerate(zip(*masks)):
        assert b.dtype == bool and b.shape == (48, 64)
        np.testing.assert_array_equal(b, a, err_msg=f"frame {i}")
    if case == "failsafe":
        assert all(m.all() for m in masks[1])
    elif case.startswith("no detector"):
        assert any((~m).any() for m in masks[1][1:])  # the flow marks the moving blocks


def test_first_frame_heuristic_matches_reference():
    """Saturated and dark vehicle-sized blobs low in the frame, on frame 0
    without a detector."""
    img = np.full((3, 60, 80), 0.5, np.float32)
    img[:, 36:50, 10:30] = np.array([0.9, 0.1, 0.1], np.float32)[:, None, None]
    img[:, 40:52, 50:66] = 0.05
    a = jm.DynamicObjectMasker(use_flow=False).get_static_mask(img, frame_idx=0)
    b = tm.DynamicObjectMasker(use_flow=False).get_static_mask(img, frame_idx=0)
    np.testing.assert_array_equal(b, a)
    assert (~b).sum() > 200


def test_ground_and_shadow_repair_match_reference():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (60, 80, 3)).astype(np.uint8)
    img[40:, :] = [100, 95, 90]
    img[44:52, 12:30] = [40, 40, 40]
    g = [mod.segment_ground(img) for mod in (jm, tm)]
    np.testing.assert_array_equal(g[1], g[0])
    veh = np.zeros((60, 80), bool)
    veh[42:54, 20:40] = True
    rj, sj = jm.repair_ground_shadows(img, veh, g[0])
    rt, st = tm.repair_ground_shadows(img, veh, g[1])
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(rt, rj)
    vj, vt = jm.ColorfulSegmentationVisualizer(), tm.ColorfulSegmentationVisualizer()
    np.testing.assert_array_equal(vt.render(img, [veh], ["car"], [True]),
                                  vj.render(img, [veh], ["car"], [True]))


def test_interval_masker_matches_reference():
    """Cadence (the ladder on frames 0, 3, 6 only) and the masks between."""
    outs, calls = [], []
    for mod in (jm, tm):
        det = _Det([[[4, 18, 24, 36]], [[30, 10, 50, 30]]], [[0.9], [0.9]])
        im = mod.IntervalMasker(mod.DynamicObjectMasker(detector=det, use_sam=False, use_flow=False),
                                interval=3)
        outs.append([im.get_static_mask(f, frame_idx=i) for i, f in enumerate(_frames(8))])
        calls.append(det.n)
    assert calls[0] == calls[1]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


class _GTData:
    """A dataset stand-in with a GT static mask per frame, as a tensor (the
    port's dataset keeps it on its device) or an array (the reference's)."""

    def __init__(self, tensor: bool):
        self.tensor = tensor

    def get_gt_static_mask(self, idx):
        m = np.ones((48, 64), bool)
        m[10 + idx:24 + idx, 5:20] = False
        m[30:40, 40 + 2 * idx:52 + 2 * idx] = False
        m[2, 2] = False  # a speck under the oracle detector's minimum area
        return torch.as_tensor(m) if self.tensor else m


def test_oracle_hooks_match_reference():
    """OracleDetector boxes, OracleSegmenter masks, OracleMasker and the
    OracleLadderMasker ladder on GT masks, frame by frame."""
    jd, td = _GTData(False), _GTData(True)
    bj, sj = jo._boxes_from_mask(~jd.get_gt_static_mask(3))
    bt, st = to._boxes_from_mask(~jd.get_gt_static_mask(3))
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(st, sj)
    assert len(bt) == 2
    lj, lt = jo.OracleLadderMasker(jd), to.OracleLadderMasker(td)
    for i, f in enumerate(_frames()):
        np.testing.assert_array_equal(to.OracleMasker(td).get_static_mask(f, frame_idx=i),
                                      jo.OracleMasker(jd).get_static_mask(f, frame_idx=i))
        np.testing.assert_array_equal(lt.get_static_mask(f, frame_idx=i), lj.get_static_mask(f, frame_idx=i))


def test_dynamic_filter_matches_reference():
    from lvdgs_tpu.perception.dynamic_filter import DynamicObjectFilter as JF
    from lvdgs_torch.perception.dynamic_filter import DynamicObjectFilter as TF

    img = (np.asarray(_frames(1)[0]).transpose(1, 2, 0) * 255).astype(np.uint8)

    def det(img, prompt, conf):
        return np.array([[4.0, 18.0, 24.0, 36.0]]), np.array([0.9])

    for seg in (None, _seg):
        a = JF(detector=det, segmenter=seg).get_static_mask(img)
        b = TF(detector=det, segmenter=seg).get_static_mask(img)
        np.testing.assert_array_equal(b, a)
    assert TF().prompt == JF().prompt


def _tiny_checkpoints(tmp_path, monkeypatch):
    """TINY GroundingDINO and SAM, random, written in the official layouts
    (GroundingDINO's state dict under "model", SAM's bare); the loaders'
    default configs set to TINY."""
    from lvdgs_torch.models.groundingdino import convert as gconv
    from lvdgs_torch.models.groundingdino import model as gm
    from lvdgs_torch.models.sam import convert as sconv
    from lvdgs_torch.models.sam import model as sm

    monkeypatch.setattr(gconv, "GroundingDINOConfig", lambda: gm.TINY_GDINO)
    monkeypatch.setattr(sconv, "SAMConfig", lambda: sm.TINY)
    gd, sam = tmp_path / "groundingdino.pth", tmp_path / "sam.pth"
    torch.save({"model": gm.init_params(gm.TINY_GDINO, torch.Generator().manual_seed(0), "cpu").state_dict()}, gd)
    torch.save(sm.init_params(sm.TINY, torch.Generator().manual_seed(1), "cpu").state_dict(), sam)
    return str(gd), str(sam)


def test_build_masker_and_model_hooks_load_the_ports_models(tmp_path, monkeypatch):
    """build_masker as the reference's; configured checkpoints load the
    port's GroundingDINO and SAM onto the asked device; a missing, broken
    or incomplete file leaves the hook empty (the reference's ladder then
    runs without the model), and so does a missing card when no device is
    asked for."""
    from lvdgs_torch.models.groundingdino.inference import GroundingDINODetector
    from lvdgs_torch.models.sam.inference import SAMSegmenter

    assert build_masker({}) is None and jbuild({}) is None
    cfg = {"dynamic_filtering": {"enabled": True, "scene_type": "highway", "use_flow": False}}
    m, mj = build_masker(cfg), jbuild(cfg)
    assert isinstance(m, tm.DynamicObjectMasker)
    assert m.prompt_manager.get_dynamic_prompt() == mj.prompt_manager.get_dynamic_prompt()
    assert (m.use_flow, m.use_sam, m.detector, m.segmenter) == (False, True, None, None)

    gd, sam = _tiny_checkpoints(tmp_path, monkeypatch)
    df = {"enabled": True, "scene_type": "parking", "use_flow": False, "grounding_dino_checkpoint": gd,
          "sam_checkpoint": sam}
    m = build_masker({"dynamic_filtering": df}, device="cpu")
    assert isinstance(m.detector, GroundingDINODetector) and isinstance(m.segmenter, SAMSegmenter)
    for model in (m.detector.model, m.segmenter.model):
        assert all(p.device.type == "cpu" for p in model.parameters())
    assert m.warmup()["detector_ok"] and m.warmup()["segmenter_ok"]

    broken = tmp_path / "broken.pth"
    broken.write_bytes(b"not a checkpoint")
    incomplete = tmp_path / "incomplete.pth"
    sd = torch.load(sam, weights_only=True)
    del sd["mask_decoder.iou_token.weight"]
    torch.save(sd, incomplete)
    for bad in (str(tmp_path / "missing.pth"), str(broken), str(incomplete)):
        m = build_masker({"dynamic_filtering": {**df, "grounding_dino_checkpoint": bad, "sam_checkpoint": bad}},
                         device="cpu")
        assert (m.detector, m.segmenter) == (None, None), bad
    if not torch.cuda.is_available():
        m = build_masker({"dynamic_filtering": df})
        assert (m.detector, m.segmenter) == (None, None)


@pytest.fixture(scope="module")
def hf_model_dir(tmp_path_factory):
    """A tiny random HF GroundingDINO and its processor (a WordPiece vocab
    holding the prompt's words), saved for from_pretrained."""
    transformers = pytest.importorskip("transformers")
    from transformers import BertConfig, BertTokenizerFast, GroundingDinoConfig, GroundingDinoForObjectDetection
    from transformers import GroundingDinoImageProcessor, GroundingDinoProcessor, SwinConfig

    d = tmp_path_factory.mktemp("hf_gdino")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", "car", "person", "truck", "bus"]
    (d / "vocab.txt").write_text("\n".join(words) + "\n")
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"), do_lower_case=True)
    proc = GroundingDinoProcessor(image_processor=GroundingDinoImageProcessor(
        size={"shortest_edge": 64, "longest_edge": 96}), tokenizer=tok)
    swin = SwinConfig(image_size=96, patch_size=4, embed_dim=16, depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8],
                      window_size=2, drop_path_rate=0.0, out_features=["stage2", "stage3", "stage4"])
    bert = BertConfig(vocab_size=len(words), hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                      intermediate_size=64, max_position_embeddings=64)
    cfg = GroundingDinoConfig(backbone_config=swin, text_config=bert, num_queries=10, encoder_layers=1,
                              decoder_layers=1, encoder_ffn_dim=64, decoder_ffn_dim=64,
                              encoder_attention_heads=2, decoder_attention_heads=2, d_model=32,
                              encoder_n_points=2, decoder_n_points=2, max_text_len=32, dropout=0.0)
    torch.manual_seed(0)
    GroundingDinoForObjectDetection(cfg).eval().save_pretrained(d)
    proc.save_pretrained(d)
    return str(d)


def test_hf_detector_matches_reference(hf_model_dir):
    img = (np.random.default_rng(8).uniform(0, 255, (48, 64, 3))).astype(np.uint8)
    kw = dict(box_threshold=0.0, text_threshold=0.0)
    ours = tm.HFGroundingDINODetector(hf_model_dir, device="cpu", **kw)
    ref = jm.HFGroundingDINODetector(hf_model_dir, **kw)
    assert ours.ok and ref.ok
    assert next(ours.model.parameters()).device.type == "cpu"
    (tb, ts), (jb, js) = ours(img, "car . person ."), ref(img, "car . person .")
    assert len(tb) == len(jb) > 0
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    # a model that is not there gives a detector that finds nothing
    missing = tm.HFGroundingDINODetector(hf_model_dir + "/missing", device="cpu")
    assert not missing.ok and missing(img, "car .")[0].shape == (0, 4)


# ---------------------------------------------------------------------------
# port copies of the reference's masker tests


def test_masker_fallback_no_models():
    """Port copy of tests/test_components.py::test_masker_fallback_no_models."""
    pm = tm.ScenePromptManager("outdoor_street")
    assert "car" in pm.get_dynamic_prompt()
    masker = tm.DynamicObjectMasker(use_flow=True)
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, size=(3, 48, 64)).astype(np.float32)
    m0 = masker.get_static_mask(img, frame_idx=0)
    assert m0.shape == (48, 64) and m0.dtype == bool
    m1 = masker.get_static_mask(img, frame_idx=1)
    assert m1.shape == (48, 64)
    assert m1.mean() > 0.95


def test_interval_masker_cadence_and_provider():
    """Port copy of tests/test_components.py::test_interval_masker_cadence_and_provider."""
    calls = []

    class Det:
        def __call__(self, img, prompt):
            calls.append(img.shape)
            return (np.array([[10.0, 10.0, 40.0, 30.0]], np.float32), np.array([0.9], np.float32))

    ladder = tm.DynamicObjectMasker(detector=Det(), use_sam=False, use_flow=False)
    n_warmup = len(calls)
    im = tm.IntervalMasker(ladder, interval=5, image_provider=lambda i: np.full((48, 64, 3), 100, np.uint8))
    assert im.provides_images
    for i in range(10):
        mask = im.get_static_mask(None, frame_idx=i)
        assert mask.shape == (48, 64)
    assert len(calls) - n_warmup == 2
    assert all(s == (48, 64, 3) for s in calls[n_warmup:])


def test_dynamic_filter_no_detector():
    """Port copy of tests/test_aux.py::test_dynamic_filter_no_detector."""
    from lvdgs_torch.perception.dynamic_filter import DynamicObjectFilter

    f = DynamicObjectFilter()
    img = np.zeros((16, 24, 3), np.uint8)
    assert f.get_dynamic_mask(img).sum() == 0
    assert f.get_static_mask(img).all()


def test_masker_ground_option_forces_ground_static():
    """Port copy of tests/test_aux.py::test_masker_ground_option_forces_ground_static."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (60, 80, 3)).astype(np.uint8)
    img[40:, :] = [100, 95, 90]

    def fake_detector(img_u8, prompt):
        return np.array([[10.0, 30.0, 70.0, 59.0]]), np.array([0.9])

    m = tm.DynamicObjectMasker(detector=fake_detector, use_flow=False, use_ground_segmentation=True)
    static = m.get_static_mask_for_gaussian_init(img, frame_idx=0)
    m2 = tm.DynamicObjectMasker(detector=fake_detector, use_flow=False)
    static2 = m2.get_static_mask_for_gaussian_init(img, frame_idx=0)
    assert static[55:].mean() > static2[55:].mean()


def test_masker_takes_tensors_and_dumps_its_stages(tmp_path):
    """The port's masker takes a (3, H, W) tensor (through .cpu()) and, with
    save_images, writes the reference's per-stage dump layout and the
    keyframe overlay."""
    det = _Det([[[4, 18, 24, 36]]], [[0.9]])
    m = tm.DynamicObjectMasker(detector=det, use_sam=False, use_flow=True, save_dir=str(tmp_path),
                               save_images=True)
    f = _frames(2)
    a = m.get_static_mask(torch.as_tensor(f[0]), frame_idx=0)
    b = tm.DynamicObjectMasker(detector=_Det([[[4, 18, 24, 36]]], [[0.9]]), use_sam=False,
                               use_flow=True).get_static_mask(f[0], frame_idx=0)
    np.testing.assert_array_equal(a, b)
    m.save_keyframe_overlay(torch.as_tensor(f[0]), torch.as_tensor(a), 0)
    for d in ("original", "grounding_dino_detections", "final_masks", "masked_overlay", "static_only",
              "keyframes", "detection_analysis"):
        assert len(list((tmp_path / d).iterdir())) == 1, d
