"""map_launches_per_cam_iter (launches): kernels (not copies or sets) whose
device start lies inside one of the program's `kf_mapping` spans of the
traced period, over the `map.cam_iters` counted inside those spans (each
mapping iteration's rendered cameras, summed)."""

from program_spans import counted, kernels_in, traced_spans


def read(record):
    got = traced_spans(record, "kf_mapping")
    if got is None:
        return None
    trace, mapping, counts = got
    cam_iters = counted(counts, "map.cam_iters", mapping)
    if not cam_iters:
        return None
    return kernels_in(trace, mapping) / cam_iters
