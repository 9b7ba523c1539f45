"""MASt3R in PyTorch: the two-view network, matching, the SLAM priors and
the ground-truth oracle (port of ``lvdgs_tpu/models/mast3r``; its
`cloud_opt` and `coarse_to_fine` wait for ROADMAP A12b)."""
from .matching import fast_reciprocal_nns
from .model import TINY, MASt3R, MASt3RConfig, init_params, mast3r_forward, mast3r_forward_fused
