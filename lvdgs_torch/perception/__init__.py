"""Perception stack: dynamic-object masking (detector + segmenter + flow),
with the reference's fallback ladder (port of ``lvdgs_tpu/perception``).

`build_masker(config)` returns None when dynamic filtering is disabled and
the masking ladder otherwise: without model hooks it runs the flow and
first-frame heuristics, as the reference's import-guard ladder does
(reference utils/slam_frontend.py:10-26, 303-306, 570-671). A configured
GroundingDINO or SAM checkpoint raises NotImplementedError until ROADMAP
A13 ports those models.
"""
from __future__ import annotations


def build_masker(config: dict):
    df = config.get("dynamic_filtering", {}) or {}
    if not df.get("enabled", False):
        return None
    from .masking import DynamicObjectMasker

    return DynamicObjectMasker(
        scene_type=df.get("scene_type", "outdoor_street"),
        use_sam=df.get("use_sam", True),
        use_flow=df.get("use_flow", True),
        save_dir=df.get("save_dir"),
        save_images=df.get("save_masked_images", False),
        grounding_dino_checkpoint=df.get("grounding_dino_checkpoint"),
        sam_checkpoint=df.get("sam_checkpoint"),
        use_ground_segmentation=df.get("use_ground_segmentation", False),
    )
