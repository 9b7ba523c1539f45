"""track_ms (ms): SLAM.timer's tracking phase (ended by the tracker's host
transfer and, in the traced run, a device synchronise), the mean over the
tracked frames of the measured periods."""


def read(record):
    t = [r["timers"]["tracking"] for r in record["records"] if r["timers"]["tracking"] > 0.0]
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
