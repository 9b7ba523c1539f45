"""kf_ms (ms): a keyframe's orchestration, fusion, seeding, mapping and
pruning (SLAM.timer's kf_fusion + kf_seed + kf_mapping + kf_prune, each
ended by a device synchronise in the traced run), the mean over the
keyframes of the measured periods."""

PHASES = ("kf_fusion", "kf_seed", "kf_mapping", "kf_prune")


def read(record):
    kfs = [r for r in record["records"] if r["kf"]]
    if not kfs:
        return None
    return 1e3 * sum(sum(r["timers"][p] for p in PHASES) for r in kfs) / len(kfs)
