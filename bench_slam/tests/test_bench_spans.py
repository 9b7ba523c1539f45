"""The readers of the program's spans and counters (metrics/track_iter_ms,
track_launches_per_iter, map_launches_per_cam_iter, host_wait_pct) on
hand-built records, and their silence where the program keeps none."""
import pytest

from cells import metric_reader
from lvdgs_torch.core import log
from lvdgs_torch.core.log import Count, Span

NAMES = ("track_iter_ms", "track_launches_per_iter", "map_launches_per_cam_iter", "host_wait_pct")


def _record(trace=True):
    """Two frames from t = 10 to 20: a tracked one (tracking 10.5-11.5 s,
    40 iterations, a read 11.4-11.5) and a keyframe (tracking 12-13, 60
    iterations; kf_mapping 14-18, 3 runs of 50 x 4 cameras; reads 12.9-13
    and 15-15.5, a phase_sync 18-18.2)."""
    spans = [
        Span("sync", 11.4, 11.5, 2, 1, 0, 1), Span("tracking", 10.5, 11.5, 1, 0, 0, 1),
        Span("sync", 12.9, 13.0, 4, 3, 0, 2), Span("tracking", 12.0, 13.0, 3, 0, 0, 2),
        Span("sync", 15.0, 15.5, 6, 5, 0, 2), Span("phase_sync", 18.0, 18.2, 7, 5, 0, 2),
        Span("kf_mapping", 14.0, 18.2, 5, 0, 0, 2),
        Span("tracking", 30.0, 31.0, 8, 0, 0, 9),  # after the measured records
    ]
    counts = [Count("track.iterations", 40, 11.45, 1, 0, 1), Count("track.iterations", 60, 12.95, 3, 0, 2),
              Count("track.iterations", 99, 30.5, 8, 0, 9)]
    counts += [Count("map.cam_iters", 200, 14.1 + k, 5, 0, 2) for k in range(3)]
    events = ([("kernel_a", 10.6 + 0.001 * k, 10.6001 + 0.001 * k) for k in range(300)]
              + [("Memcpy HtoD", 10.7, 10.71), ("kernel_b", 11.9, 11.95)]
              + [("kernel_c", 12.1 + 0.001 * k, 12.1001 + 0.001 * k) for k in range(500)]
              + [("kernel_d", 14.0 + 0.0001 * k, 14.00005 + 0.0001 * k) for k in range(30000)]
              + [("Memset", 15.0, 15.1)])
    rec = {"t0": 10.0, "records": [{"t0": 10.0, "t1": 12.0, "kf": False}, {"t0": 12.0, "t1": 20.0, "kf": True}],
           "trace": {"t_start": 9.9, "t_stop": 20.5, "events": events} if trace else None}
    return rec, (spans, counts)


@pytest.fixture
def program(monkeypatch):
    rec, got = _record()

    def recorded(t0, t1):
        spans, counts = got
        return ([s for s in spans if s.start >= t0 and s.end <= t1],
                [c for c in counts if t0 <= c.t <= t1])

    monkeypatch.setattr(log, "recorded", recorded)
    return rec


def test_readers_on_hand_built_spans(program):
    read = {n: metric_reader(n) for n in NAMES}
    assert read["track_iter_ms"](program) == pytest.approx(1e3 * 2.0 / 100)
    assert read["track_launches_per_iter"](program) == pytest.approx(800 / 100)
    assert read["map_launches_per_cam_iter"](program) == pytest.approx(30000 / 600)
    # the reads 0.1 + 0.1 + 0.5 s of the records' 10 s; phase_sync left out
    assert read["host_wait_pct"](program) == pytest.approx(7.0)


def test_the_device_readers_need_a_trace(program):
    program["trace"] = None
    assert metric_reader("track_launches_per_iter")(program) is None
    assert metric_reader("map_launches_per_cam_iter")(program) is None
    assert metric_reader("track_iter_ms")(program) is not None


def test_a_program_without_the_recorder_reports_nothing(monkeypatch):
    monkeypatch.delattr(log, "recorded")
    rec, _ = _record()
    for n in NAMES:
        assert metric_reader(n)(rec) is None, n


def test_no_iterations_no_reading(monkeypatch):
    rec, _ = _record()
    monkeypatch.setattr(log, "recorded", lambda t0, t1: ([], []))
    for n in NAMES[:3]:
        assert metric_reader(n)(rec) is None, n
    assert metric_reader("host_wait_pct")(rec) == 0.0
