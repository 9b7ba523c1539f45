"""host_wait_pct (%): the share of the measured records' wall in which the
host waited on the device in one of the program's `sync` spans (its
device-to-host reads and the other calls that wait for the device's
queue); the traced run's own waits (`phase_sync`) are not counted."""

from devtrace import union_seconds
from program_spans import named, window


def read(record):
    got = window(record)
    if got is None:
        return None
    recs = record["records"]
    lo, hi = recs[0]["t0"], recs[-1]["t1"]
    waits = named(got[0], "sync")
    return 100.0 * union_seconds(((s.start, s.end) for s in waits), lo, hi) / (hi - lo)
