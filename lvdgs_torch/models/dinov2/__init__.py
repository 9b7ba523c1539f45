"""DINOv2 in PyTorch (port of ``lvdgs_tpu/models/dinov2``)."""
from .model import TINY_DINO, DINOv2, DINOv2Config, convert_state_dict, dinov2_forward, init_params, load_hub
