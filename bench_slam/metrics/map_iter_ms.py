"""map_iter_ms (ms): keyframe mapping time per camera-iteration: SLAM.timer's
kf_mapping (device-synchronised in the traced run) over the mapping
iterations the keyframe added (SLAM.iteration_count) times the cameras each
iteration rendered (the window and the replay keyframes), over the
keyframes of the measured periods."""


def read(record):
    kfs = [r for r in record["records"] if r["kf"] and r["iters"] > 0]
    work = sum(r["iters"] * r["cams"] for r in kfs)
    if not work:
        return None
    return 1e3 * sum(r["timers"]["kf_mapping"] for r in kfs) / work
