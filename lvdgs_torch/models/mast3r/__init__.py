"""MASt3R in PyTorch: the two-view network, matching, the SLAM priors, the
ground-truth oracle, cloud optimisation (`cloud_opt`) and coarse-to-fine
matching (`coarse_to_fine`) (port of ``lvdgs_tpu/models/mast3r``)."""
from .cloud_opt import (
    SparseGAConfig, batched_triangulate, matches_to_depths, sparse_global_alignment, sparse_scene_optimizer,
    tsdf_refine_depths,
)
from .coarse_to_fine import refine_matches, select_crop_pairs
from .matching import fast_reciprocal_nns
from .model import TINY, MASt3R, MASt3RConfig, init_params, mast3r_forward, mast3r_forward_fused
