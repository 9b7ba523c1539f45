"""track_iter_ms (ms): tracking's time per iteration: the program's
`tracking` spans (a tracked frame's pose seed, tracker and pose read, up to
the pose-out time) within the measured records, summed, over the
`track.iterations` counted inside them. Divides out the iterations a frame
takes, which set pose_ms's spread."""

from program_spans import counted, named, window


def read(record):
    got = window(record)
    if got is None:
        return None
    spans, counts = got
    track = named(spans, "tracking")
    iters = counted(counts, "track.iterations", track)
    if not iters:
        return None
    return 1e3 * sum(s.end - s.start for s in track) / iters
