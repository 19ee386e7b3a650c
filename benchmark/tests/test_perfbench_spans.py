"""The six readers of the program's spans on synthetic runs: spans placed
by hand on the host clock, a trace whose clock is the host's shifted by a
known amount, values computed by hand; spans outside the traced stretch
count for nothing, and without a trace or a recorder every reader gives
None."""

import numpy as np
import pytest

from benchmark import harness, spans

READERS = ("unpack_build_ms", "round_blocked_ms", "recovery_rows",
           "acquire_device_ms", "decode_device_ms", "idle_build_share")
SHIFT = -99_999_500.0           # trace us = host s x 1e6 + SHIFT
MS = 1e-3                       # host seconds


def _run(device_gaps=None, traced=3, before=2):
    """before + traced rounds of 20 ms from t = 100 s: round() 10 ms, then
    unpack() 10 ms; the last `traced` rounds traced, the device busy
    through each round() and idle through each unpack() unless
    device_gaps [(start, end) host s] say where it idles instead."""
    rounds = []
    for r in range(before + traced):
        a = 100.0 + 20 * MS * r
        rounds.append((a, a + 10 * MS, a + 20 * MS, 4))
    active = rounds[-traced:]
    phases = [(a * 1e6 + SHIFT, b * 1e6 + SHIFT, c * 1e6 + SHIFT)
              for a, b, c, _ in active]
    lo, hi = phases[0][0], phases[-1][2]
    if device_gaps is None:
        device_gaps = [(b, c) for _, b, c, _ in active]
    ops, cur = [], lo
    for s, e in sorted(device_gaps):
        s, e = s * 1e6 + SHIFT, e * 1e6 + SHIFT
        ops.append(("k", cur, s))
        cur = e
    ops.append(("k", cur, hi))
    tr = harness.Trace(ops, lo, hi, traced, {}, phases)
    return harness.Run(4, 1000, rounds, 0.1, 1.0, traced_rounds=traced + 1,
                       trace=tr)


def _spans(run, device=True):
    """Per round: rx.acquire 1-3 ms (card 1.5 ms), rx.decode 3-8 ms (card
    4.0 ms) holding rx.read 4-4.5 ms and rx.recovery 4.5-7 ms of 5 rows,
    pool.unpack.build 12-19 ms; in the untraced rounds each 10x longer,
    with 10x the rows and device time."""
    rows = []
    traced = run.trace.rounds
    for r, (a, _b, _c, _n) in enumerate(run.rounds):
        k = 1 if r >= len(run.rounds) - traced else 10
        for name, s, e, n, dev in (
                ("rx.acquire", 1, 3, 0, 1.5), ("rx.decode", 3, 8, 0, 4.0),
                ("rx.read", 4, 4.5, 0, np.nan),
                ("rx.recovery", 4.5, 7, 5, np.nan),
                ("pool.unpack.build", 12, 19, 0, np.nan)):
            e, n, dev = s + (e - s) * k, n * k, dev * k
            rows.append((name, int(round((a + s * MS) * 1e9)),
                         int(round((a + e * MS) * 1e9)), n, dev))
    name, start, end, n, dev = zip(*rows)
    return {"name": np.array(name), "start_ns": np.array(start, np.int64),
            "end_ns": np.array(end, np.int64), "n": np.array(n, np.int64),
            "device_ms": np.array(dev) if device else None}


@pytest.fixture
def record(monkeypatch):
    def put(value):
        monkeypatch.setattr(spans, "recorded", lambda: value)
    return put


def test_readers_by_hand(record):
    run = _run()
    record(_spans(run))
    got = {name: harness.reader(name)(run) for name in READERS}
    assert got == pytest.approx({
        "unpack_build_ms": 7.0, "round_blocked_ms": 0.5,
        "recovery_rows": 5.0, "acquire_device_ms": 1.5,
        "decode_device_ms": 4.0,
        # each round idles 10 ms in unpack(), 7 of them in the build
        "idle_build_share": 0.7})
    assert spans.shift_us(run) == pytest.approx(SHIFT)


def test_spans_outside_the_stretch_are_ignored(record):
    run = _run()
    s = _spans(run)
    record(s)
    # the untraced rounds' spans alone: nothing in the stretch
    early = s["start_ns"] < int(run.rounds[-run.trace.rounds][0] * 1e9)
    assert early.any() and not early.all()
    record({k: (v[early] if v is not None else None) for k, v in s.items()})
    assert all(harness.reader(n)(run) is None for n in READERS)


def test_idle_inside_or_outside_the_build(record):
    a, b, _c, _ = _run().rounds[-2]
    # one gap of the device, 3 ms in a traced round's build (12-19 ms), or
    # in its round() (2-5 ms)
    for gap, want in (((b + 3 * MS, b + 6 * MS), 1.0),
                      ((a + 2 * MS, a + 5 * MS), 0.0)):
        run = _run(device_gaps=[gap])
        record(_spans(run))
        assert harness.reader("idle_build_share")(run) == pytest.approx(want)


def test_no_trace_or_no_recorder_gives_none(record):
    run = _run()
    record(_spans(run))
    run.trace = None
    assert all(harness.reader(n)(run) is None for n in READERS)
    record(None)
    assert all(harness.reader(n)(_run()) is None for n in READERS)


def test_no_device_time_and_no_recovery(record):
    """Off the card the device readers give None; a stretch without
    recovery or reads gives 0 for both."""
    run = _run()
    s = _spans(run, device=False)
    keep = ~np.isin(s["name"], ["rx.read", "rx.recovery"])
    record({k: (v[keep] if v is not None else None) for k, v in s.items()})
    assert harness.reader("acquire_device_ms")(run) is None
    assert harness.reader("decode_device_ms")(run) is None
    assert harness.reader("round_blocked_ms")(run) == 0.0
    assert harness.reader("recovery_rows")(run) == 0.0
    assert harness.reader("unpack_build_ms")(run) == pytest.approx(7.0)
