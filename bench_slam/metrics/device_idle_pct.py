"""device_idle_pct (%): 100 less the share of the traced window in which
some operation (a kernel, copy or set of any stream) ran on the device."""

from devtrace import union_seconds


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    lo, hi = tr["t_start"], tr["t_stop"]
    busy = union_seconds(((s, e) for _n, s, e in tr["events"]), lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
