"""blend_fwd_roofline (%): the packed blend forward's (B4, float32)
least time at the H100's published peaks, from each launch's pack shape
and march lengths logged in the traced window (roofline.packed_work), over
the device time of the kernels named packed_fwd_kernel<false, ...> there."""

from roofline import roofline_pct


def read(record):
    return roofline_pct(record, "fwd", "packed_fwd_kernel<false")
