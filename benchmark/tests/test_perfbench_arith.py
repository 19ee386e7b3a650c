"""The benchmark's arithmetic on synthetic runs: the tail over all rounds,
the rate over the window, the device's busy union and the roofline
bounds against counts made by hand."""

import math

import numpy as np
import pytest

from benchmark import harness, yardstick


def _run(round_ms, channels=4, chunk=1000, trace=None, traced=0):
    rounds, t = [], 100.0
    for ms in round_ms:
        rounds.append((t, t + ms / 2e3, t + ms / 1e3, channels))
        t += ms / 1e3
    return harness.Run(channels, chunk, rounds, t - 100.0, 12.5,
                       traced_rounds=traced, trace=trace)


def test_p95_is_over_every_round():
    ms = [10.0] * 95 + [50.0] * 4 + [90.0]
    run = _run(ms)
    assert harness.reader("round_p95_ms")(run) == pytest.approx(10.0)
    run = _run([10.0] * 94 + [50.0] * 6)
    assert harness.reader("round_p95_ms")(run) == pytest.approx(50.0)
    assert yardstick.nearest_rank([3, 1, 2], 0.5) == 2


def test_rate_is_all_work_over_all_time():
    run = _run([10.0] * 50 + [30.0] * 50, channels=4, chunk=1000)
    # 100 rounds x 4 channels x 1000 samples over 2.0 s
    assert harness.reader("ingest_msamples_s")(run) == pytest.approx(0.2)
    assert harness.reader("setup_s")(run) == 12.5


def test_span_means_skip_the_profiled_rounds():
    run = _run([10.0] * 8 + [40.0] * 3, traced=3)
    assert harness.reader("round_issue_ms")(run) == pytest.approx(5.0)
    assert harness.reader("pool_unpack_ms")(run) == pytest.approx(5.0)


def test_busy_union_and_idle_share():
    busy, gaps = yardstick.busy_union(
        [(0, 10), (5, 15), (20, 30), (28, 29), (40, 60)], 0, 50)
    assert busy == 35 and gaps == [(15, 20), (30, 40)]
    tr = harness.Trace([("k", 0, 10), ("k", 5, 15), ("m", 20, 30)],
                       0.0, 40.0, 2, {}, [(0.0, 10.0, 20.0), (20.0, 30.0, 40.0)])
    run = _run([20.0, 20.0], trace=tr)
    assert harness.reader("device_idle_share")(run) == pytest.approx(0.375)
    assert harness.reader("rx_device_ops")(run) == pytest.approx(1.5)
    assert harness.breakdown(tr)["idle_gaps"][0] == [
        "unpack()", pytest.approx(10e-6)]


def test_ldpc_bound_by_hand():
    edges = yardstick.ldpc_edges(8)
    c_idx = np.load(yardstick.LDPC_TABLES)["8_16_C"]
    assert edges == int((c_idx >= 0).sum())
    rows, sweeps = 256, 3.5
    flops = 24 * edges * rows * sweeps
    nbytes = 4 * rows * 1600 + 8 * rows * 1600 + 9 * rows
    want = max(flops / 67e12, nbytes / 3.35e12) * 1e3
    assert yardstick.ldpc_bound_ms(8, rows, "spa", sweeps, False) == \
        pytest.approx(want)
    soft = nbytes + 4 * rows * 1600
    assert yardstick.ldpc_bound_ms(14, 10, "minsum", 1.0, True) == \
        pytest.approx(max(10 * yardstick.ldpc_edges(14) * 10 / 67e12,
                          (soft / rows * 10) / 3.35e12) * 1e3)


def test_fir_bound_by_hand():
    # 2 rows of n=100 from start 0 ("same" form): windows clipped at 0/n
    n, ntaps, stride = 100, 5, 4
    n_out, offset = (n - 1) // stride + 1, (ntaps - 1) // 2
    pb_n, osc_n = yardstick.fir_window_samples(
        n, np.zeros(2, np.int64), n_out, stride, offset, ntaps)
    assert (pb_n, osc_n) == (2 * 99, 99)
    got = yardstick.fir_bound_ms(2, n, np.zeros(2, np.int64), n_out, stride,
                                 offset, ntaps, False)
    nbytes = 4 * pb_n + 8 * osc_n + 4 * ntaps + 8 * 2 * n_out
    flops = 2 * pb_n + 4 * 2 * n_out * ntaps
    assert got == pytest.approx(max(nbytes / 3.35e12, flops / 67e12) * 1e3)


def test_roofline_readers_divide_bound_by_device_time():
    tr = harness.Trace(
        [("ldpc_layered_kernel(float)", 0, 1000),
         ("mix_fir_decimate_kernel<4>", 1000, 1500),
         ("mix_fir_decimate_kernel<4>", 2000, 2500)], 0.0, 3000.0, 1,
        {"ldpc_layered": [0.01], "mix_fir_decimate": [0.2, 0.3]},
        [(0.0, 1000.0, 3000.0)])
    run = _run([3.0], trace=tr)
    assert harness.reader("ldpc_roofline_pct")(run) == pytest.approx(1.0)
    assert harness.reader("fir_roofline_pct")(run) == pytest.approx(50.0)
    tr.launches = {}
    assert harness.reader("ldpc_roofline_pct")(run) is None
    assert math.isfinite(harness.reader("device_idle_share")(run))
