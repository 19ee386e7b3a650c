"""CONFIG_3 in the benchmark: the frozen transmitter's frames equal the
port's, the matched filter's work count is the program's two launches of
a receive, the two readers of the noncoherent scan on synthetic stretches,
the c3_pool_scan cell correct at three channels while its control is not,
and the broken paths of the fault tests failing the cell (CPU, plain
versions; the cell's own size on the card under the cuda marker, with the
timed path's scan held against benchmark/nc_scan.py and the frames that
only the scan's rows find counted)."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, nc_scan, spans, traffic, txref
from benchmark.tests.test_perfbench_faults import half_batch, stale_state
from mercury_tpu_torch import obs
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.modem import sync
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import serve

CELL = "c3_pool_scan"
READERS = ("nc_scan_device_ms", "nc_mf_roofline_pct")


def _mode():
    return txref.build_mode(json.loads(
        (harness.HERE / "configs" / "mercury_config3.json").read_text()))


def test_frames_equal_the_ports():
    mode = _mode()
    g = build_geometry(3)
    assert (mode.frame_bytes, mode.frame_len) == (g.frame_bytes,
                                                  g.total_frame_size)
    pay = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (3, g.frame_bytes)).astype(np.uint8))
    want = TxChain(g, device="cpu", dtype=torch.float64).transmit(pay)
    got = txref.transmit(mode, pay)
    assert float((got.double() - want).abs().max()) < 1e-6


def test_count_is_the_programs_launches(monkeypatch):
    """A receive of the serving pool's window launches deep_mf_score
    twice, on nc_scan's scan shape and its refinement shape, and at no
    other; its one rx.nc_scan span counts the rows."""
    g = build_geometry(3)
    seen = []
    real = kernels.deep_mf_score

    def noted(seg, bank, window, nfft=None):
        seen.append((tuple(seg.shape), tuple(bank.shape), window))
        return real(seg, bank, window, nfft)

    monkeypatch.setattr(kernels, "deep_mf_score", noted)
    pool = serve.FusedDevicePool(g, 2, rx=RxChain(g, device="cpu"))
    obs.clear()
    with obs.recording():
        pool.rx.receive(torch.zeros((2, pool.buf_len)))
    s = obs.spans()
    obs.clear()
    assert seen == [
        ((2, nc_scan.SEGMENT), nc_scan.BANK, nc_scan.LAGS),
        ((nc_scan.REFINE_CANDIDATES * 2, nc_scan.REFINE_SEGMENT),
         nc_scan.REFINE_BANK, nc_scan.REFINE_LAGS)]
    assert s["n"][s["name"] == "rx.nc_scan"].tolist() == [2]
    assert nc_scan.scan_bound_ms(256) == pytest.approx(0.28928424, rel=1e-6)
    assert nc_scan.refine_bound_ms(256) == pytest.approx(0.01103984,
                                                          rel=1e-6)


def _run(dmf_us, rows_a_round, rounds=2, scan_span=True):
    """`rounds` traced rounds of 100 us on a trace whose clock is the
    host's in us: two deep_mf_score ops (the scan of dmf_us, the
    refinement of 7 us), a deep_mf_max op of 9 us (not theirs) and an LDPC
    op in each; spans rx.acquire around rx.nc_scan (n rows, 30 us on the
    card)."""
    rows, phases, ops, sp = [], [], [], []
    for r in range(rounds + 1):
        a = 1.0 + 100e-6 * r
        rows.append((a, a + 50e-6, a + 100e-6, 4))
    score = ("void (anonymous namespace)::dmf_wgmma_kernel<false, "
             "(anonymous namespace)::Tile<1, 4, {}, 16, 4>, false>"
             "((anonymous namespace)::DmfArgs)")
    for a, b, c, _ in rows[1:]:
        t = a * 1e6
        phases.append((t, b * 1e6, c * 1e6))
        ops += [(score.format(3), t + 5, t + 5 + dmf_us),
                (score.format(1), t + 60, t + 67),
                ("void (anonymous namespace)::dmf_wgmma_kernel<true, "
                 "(anonymous namespace)::Tile<4, 1, 16, 64, 2>, true>"
                 "((anonymous namespace)::DmfArgs)", t + 68, t + 77),
                ("ldpc_layered_kernel", t + 78, t + 90)]
        sp.append(("rx.acquire", t + 1, t + 70, 0, 60.0e-3))
        if scan_span:
            sp.append(("rx.nc_scan", t + 2, t + 40, rows_a_round, 30.0e-3))
    tr = harness.Trace(ops, phases[0][0], phases[-1][2], rounds, {}, phases)
    run = harness.Run(4, 1000, rows, 1.0, 1.0, traced_rounds=rounds + 1,
                      trace=tr)
    name, start, end, n, dev = zip(*sp)
    rec = {"name": np.array(name),
           "start_ns": (np.array(start) * 1e3).astype(np.int64),
           "end_ns": (np.array(end) * 1e3).astype(np.int64),
           "n": np.array(n, np.int64), "device_ms": np.array(dev)}
    return run, rec


def test_readers_by_hand(monkeypatch):
    """The scan at a quarter of its bound beside a 7 us refinement: the
    share is the two bounds over the two operations' time; the span's
    card time a round."""
    bound_ms = nc_scan.scan_bound_ms(256) + nc_scan.refine_bound_ms(256)
    dmf_us = 4 * nc_scan.scan_bound_ms(256) * 1e3
    run, rec = _run(dmf_us, 256)
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    got = {name: harness.reader(name)(run) for name in READERS}
    assert got == pytest.approx({
        "nc_scan_device_ms": 0.03,
        "nc_mf_roofline_pct": 100.0 * bound_ms / ((dmf_us + 7.0) * 1e-3)})
    # operations bound both: 8 a complex multiply-add at the TF32 peak
    assert nc_scan.scan_bound_ms(256) == pytest.approx(
        8.0 * 256 * 9 * 14281 * 544 / 495e12 * 1e3)
    assert nc_scan.refine_bound_ms(256) == pytest.approx(
        8.0 * 768 * 3 * 545 * 544 / 495e12 * 1e3)


def test_readers_without_the_span(monkeypatch):
    """A program without the rx.nc_scan span (the other cells, or a
    program from before the span) or without a recorder gives None for
    both; so does a stretch without a deep_mf_score operation."""
    run, rec = _run(100.0, 256, scan_span=False)
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    assert all(harness.reader(n)(run) is None for n in READERS)
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert all(harness.reader(n)(run) is None for n in READERS)
    run, rec = _run(100.0, 256)
    run.trace.device_ops = [op for op in run.trace.device_ops
                            if "<false" not in op[0]]
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    assert harness.reader("nc_mf_roofline_pct")(run) is None


def _serve(rx_options=None, seed=2 ** 31 + 17):
    cell = harness.load_cell(CELL)
    cell.update(channels=3, ring_blocks=3, kept_every=1)
    return harness.serve(cell, seed, 1.0, False, torch.device("cpu"),
                         time.perf_counter(), {}, rx_options=rx_options)


def test_cell_correct_and_control_not():
    """Three channels at the cell's Es/N0: the port's receiver delivers
    within the cell's limits, and with its control's options it misses
    more frames than they allow."""
    run, checks = _serve()
    assert harness.is_correct(checks), checks
    assert checks["wrong_share"]["checked"] > 0
    control = harness.load_cell(CELL)["control"]["rx_options"]
    _run_, checks = _serve(control)
    assert checks["missed_share"]["value"] > checks["missed_share"]["limit"]
    assert not harness.is_correct(checks), checks


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_faults_fail(fault, monkeypatch):
    """A stale round, half the channels left out, or altered bytes: not
    correct."""
    if fault == "altered":
        orig = serve._pack

        def pack(res, ok):
            out = orig(res, ok)
            out[:, 0] ^= 0x5A
            return out
        monkeypatch.setattr(serve, "_pack", pack)
    cell = harness.load_cell(CELL)
    cell.update(channels=3, ring_blocks=3, kept_every=1)
    _run_, checks = harness.serve(
        cell, 2 ** 31 + 19, 0.5, False, torch.device("cpu"),
        time.perf_counter(), {},
        fault={"stale": stale_state, "half": half_batch}.get(fault))
    assert not harness.is_correct(checks), checks


def timed_path_scan(cell: dict, seed: int, device: torch.device,
                    rows: int = 256, rounds: int = 4):
    """The cell's pool over its ring from `seed` for `rounds` rounds, as
    the harness serves it; the last round's scan, as the receive computed
    it, for its first `rows` rows: (segment, bank, window, delay in lags,
    score / Lp), and the pool."""
    mode = txref.build_mode(cell["mode"])
    ring = traffic.build_ring(mode, cell, seed, device)
    mcfg = cell["mode"]
    geom = build_geometry(int(mcfg["config"]), estimator=mcfg["estimator"])
    pool = serve.FusedDevicePool(geom, int(cell["channels"]), rx=RxChain(
        geom, device=device, **mcfg.get("rx_options", {})))
    seen = []
    real = sync.matched_filter_refine_bank

    def noted(seg, start, bank, window):
        delay, score = real(seg, start, bank, window)
        if seg.shape[-1] == nc_scan.SEGMENT:
            seen.append((seg[:rows].clone(), bank, window,
                         (delay - start[:, None])[:rows], score[:rows]))
        return delay, score

    sync.matched_filter_refine_bank = noted
    try:
        n = len(ring.views)
        for j in range(rounds):
            pool.unpack(pool.round(ring.views[j % n],
                                   next_block=ring.views[(j + 1) % n]))
    finally:
        sync.matched_filter_refine_bank = real
    assert len(seen) == rounds
    return seen[-1], pool


def arbitration(pool, cell: dict) -> dict:
    """The arbitration of the pool's last round, off the timed path
    (receive(stage="arb") on its windows): the rows whose pick is a scan
    row, whose pick lies within 16 samples of the frame's start, whose
    Schmidl-Cox refine rows alone would pick there, and of the rows whose
    pick is there but the refine's alone is not (the scan's finds), those
    that pass their CRC."""
    with torch.no_grad():
        delays, scores, _cfos = pool.rx.receive(pool.windows, stage="arb")
        crc_ok = pool.rx.receive(pool.windows).crc_ok
    n_refine = delays.shape[0] - nc_scan.BANK[0]
    pick = scores.argmax(0)
    chosen = delays.gather(0, pick[None])[0]
    alone = delays[:n_refine].gather(0, scores[:n_refine].argmax(0)[None])[0]
    start = pool.buf_len + (int(cell["lead_symbols"])
                            - int(cell["chunk_symbols"])) * pool.sym_len
    at = (chosen - start).abs() <= 16
    found = at & ((alone - start).abs() > 16)
    return {"rows": int(pick.numel()), "scan_pick": int((pick >= n_refine)
                                                       .sum()),
            "at_frame": int(at.sum()), "refine_alone_at_frame": int(
                ((alone - start).abs() <= 16).sum()),
            "scan_found": int(found.sum()),
            "scan_found_crc_ok": int((found & crc_ok).sum())}


@pytest.mark.cuda
def test_cell_on_the_card():
    """The cell's own size on the card, three seeds: the program correct,
    its control not; and the scan of the timed path's own segments, 256
    rows of a round, against nc_scan's reference in float64 (run: python
    -m pytest -m cuda benchmark/tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import readings
    dev = torch.device("cuda", 0)
    seeds = [2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303]
    for row in readings.readings(CELL, seeds, 4.0, False, dev):
        assert row["correct"], row
    for row in readings.readings(CELL, seeds, 4.0, True, dev):
        assert not row["correct"], row
    cell = harness.load_cell(CELL)
    (seg, bank, window, delay, score), pool = timed_path_scan(cell, seeds[0],
                                                              dev)
    got = nc_scan.compare(seg, bank, window, delay, score)
    print(f"the timed path's scan against nc_scan's reference: {got}")
    assert got["ok"] and got["delay_held"] > 0, got
    arb = arbitration(pool, cell)
    print(f"the last round's arbitration: {arb}")
    assert arb["scan_found_crc_ok"] > 0, arb
