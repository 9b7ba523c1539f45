"""Perception stack: dynamic-object masking (detector + segmenter + flow),
with the reference's fallback ladder (port of ``lvdgs_tpu/perception``).

`build_masker(config, device)` returns None when dynamic filtering is
disabled and the masking ladder otherwise (reference
utils/slam_frontend.py:10-26, 303-306, 570-671). A configured
`grounding_dino_checkpoint` or `sam_checkpoint` loads GroundingDINO or SAM
onto `device`, the card when None; a checkpoint that does not load leaves
its hook empty, and the ladder runs without that model, as in the
reference.
"""
from __future__ import annotations


def build_masker(config: dict, device=None):
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
        device=device,
    )
