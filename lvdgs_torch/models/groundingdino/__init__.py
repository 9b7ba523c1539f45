"""GroundingDINO in PyTorch: Swin-T, BERT, the detector, its checkpoint
loaders and the masker's detector hook (port of
``lvdgs_tpu/models/groundingdino``)."""
from .model import TINY_GDINO, GroundingDINO, GroundingDINOConfig, groundingdino_forward, init_params
