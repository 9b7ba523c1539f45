"""Segment Anything (ViT-B) in PyTorch: the image encoder, the prompt
encoder and mask decoder, the checkpoint loader and the masker's
segmenter hook (port of ``lvdgs_tpu/models/sam``)."""
from .model import SAM, TINY, SAMConfig, init_params, sam_encode_image, sam_predict_masks
