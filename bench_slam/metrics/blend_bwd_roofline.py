"""blend_bwd_roofline (%): the same for the packed blend backward (B5,
float32), over the kernels named packed_bwd_kernel<false> there."""

from roofline import roofline_pct


def read(record):
    return roofline_pct(record, "bwd", "packed_bwd_kernel<false")
