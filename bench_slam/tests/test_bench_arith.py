"""The arithmetic of the end-to-end rate, the device's busy union and the
kernel rooflines."""
import pytest

from devtrace import idle_gaps, union_seconds
from sequence import first_period, measured_periods, period_rate
from roofline import least_seconds, packed_work, roofline_pct


def _rec(t0, t1, kf):
    return {"t0": t0, "t1": t1, "kf": kf}


def test_measured_periods_are_the_first_whole_ones():
    recs = [_rec(0, 1, False), _rec(1, 2, False), _rec(2, 6, True),  # period 1: 3 frames, ends at 6
            _rec(6, 7, False), _rec(7, 12, True),                      # period 2: 2 frames, ends at 12
            _rec(12, 13, False), _rec(13, 18, True),                   # period 3, whole but not asked for
            _rec(18, 19, False), _rec(19, 30, True)]                   # ends after the window
    assert measured_periods(recs, 20.0, 2) == recs[:5]
    assert period_rate(measured_periods(recs, 20.0, 2), 0.0) == (5, 12.0)
    assert measured_periods(recs, 20.0, 5) == recs[:7]  # only three are whole
    assert measured_periods(recs, 5.0, 2) == []
    assert period_rate([], 0.0) == (0, 0.0)
    assert first_period(recs) == recs[:3]
    assert first_period(recs[:2]) == []


def test_union_over_several_streams():
    # three streams' operations, overlapping and nested, clipped to [1, 10]
    a = [(0.0, 2.0), (5.0, 6.0)]
    b = [(1.5, 3.0), (5.5, 5.7)]
    c = [(8.0, 12.0)]
    assert union_seconds(a + b + c, 1.0, 10.0) == pytest.approx(2.0 + 1.0 + 2.0)
    assert idle_gaps(a + b + c, 1.0, 10.0) == [(3.0, 5.0), (6.0, 8.0)]
    assert union_seconds([], 0.0, 1.0) == 0.0


def test_packed_bounds_match_the_kernel_table():
    # PERF.md's kernel table: the random street block (K 256, T 1848; NB
    # 348, 116 groups of 16 tiles) bounds B4 at 0.0115 ms and B5 at 0.0409
    # ms, both by their operations; 111,500 tile-slots marched
    fwd = least_seconds(*packed_work("fwd", 348, 116, 16, 111_500))
    bwd = least_seconds(*packed_work("bwd", 348, 116, 16, 111_500))
    assert fwd * 1e3 == pytest.approx(0.0115, rel=0.01)
    assert bwd * 1e3 == pytest.approx(0.0409, rel=0.01)


def test_roofline_reads_logged_launches_against_their_kernels():
    launch = {"kind": "fwd", "NB": 348, "G": 116, "TG": 16, "marched": 111_500, "bf16": False}
    least = least_seconds(*packed_work("fwd", 348, 116, 16, 111_500))
    rec = {"trace": {"t_start": 0.0, "t_stop": 1.0,
                     "events": [("void packed_fwd_kernel<false, 0>(...)", 0.1, 0.1 + 4 * least),
                                ("void packed_bwd_kernel<false>(...)", 0.2, 0.3)]},
           "launches": [launch, {**launch, "bf16": True}]}
    assert roofline_pct(rec, "fwd", "packed_fwd_kernel<false") == pytest.approx(25.0)
    assert roofline_pct(rec, "bwd", "packed_bwd_kernel<false") is None
    assert roofline_pct({"trace": None}, "fwd", "x") is None
