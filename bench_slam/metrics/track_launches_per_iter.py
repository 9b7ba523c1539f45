"""track_launches_per_iter (launches): kernels (not copies or sets) whose
device start lies inside one of the program's `tracking` spans of the
traced period, over the `track.iterations` counted inside those spans."""

from program_spans import counted, kernels_in, traced_spans


def read(record):
    got = traced_spans(record, "tracking")
    if got is None:
        return None
    trace, track, counts = got
    iters = counted(counts, "track.iterations", track)
    if not iters:
        return None
    return kernels_in(trace, track) / iters
