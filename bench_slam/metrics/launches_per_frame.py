"""launches_per_frame (launches): device kernels in the trace per frame,
over the window's first whole keyframe period (the traced part): the
kernels from the window's start to the end of the period, over its
frames. Copies and sets are not counted."""


def read(record):
    tr, period = record.get("trace"), record["first_period"]
    if not tr or not period:
        return None
    end = period[-1]["t1"]
    kernels = sum(1 for n, st, _e in tr["events"]
                  if record["t0"] <= st <= end and not n.startswith(("Memcpy", "Memset")))
    return kernels / len(period)
