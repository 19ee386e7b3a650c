"""CONFIG_1-4's noncoherent whole-buffer scan in the port's receive and
serving pool (CPU, plain versions): the span rx.nc_scan carries the rows
scanned on a CONFIG_3 chain and opens on no CONFIG_0 or CONFIG_9 chain;
recording changes no result; the port's scan of a CONFIG_3 window agrees
with the benchmark's direct-correlation reference (benchmark/nc_scan.py);
and FusedDevicePool delivers the port's CONFIG_3 frames at Es/N0 0.75 dB
with the bytes sent, at their known start."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import nc_scan
from mercury_tpu_torch import obs
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem import sync
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import serve


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def ring():
    """An empty span ring, emptied again after the test."""
    obs.clear()
    yield
    obs.clear()


def _capture(g, esn0_db: float, rows: int, seed: int):
    """[rows, buffer] float32: a frame at (2 + r) symbols into row r in
    white noise at esn0_db. -> (buffer, payloads)."""
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (rows, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g, device="cpu").transmit(
        torch.from_numpy(payloads)).numpy()
    sym = g.nofdm * g.interp
    n = g.nofdm * g.buffer_nsymb * g.interp
    buf = (sim.sigma_for_esn0(esn0_db) * rng.standard_normal((rows, n))
           ).astype(np.float32)
    for r in range(rows):
        lead = (2 + r) * sym
        buf[r, lead: lead + frames.shape[1]] += frames[r]
    return torch.from_numpy(buf), payloads


@pytest.mark.parametrize("cfg", [3, 0, 9])
def test_nc_scan_span(ring, cfg):
    """Three rows at 12 dB: on CONFIG_3 one rx.nc_scan inside rx.acquire,
    n = 3; on CONFIG_0 (the coherent scan) and CONFIG_9 (no deep sync)
    none. The results equal a receive's with the recorder off."""
    g = build_geometry(cfg)
    rx = RxChain(g, device="cpu")
    pb, payloads = _capture(g, 12.0, 3, 11)
    off = rx.receive(pb)
    with obs.recording():
        on = rx.receive(pb)
    for f in dataclasses.fields(on):
        assert torch.equal(getattr(on, f.name), getattr(off, f.name)), f.name
    assert on.crc_ok.all()
    for r in range(3):
        assert bytes(on.payload[r].numpy()) == bytes(payloads[r])
    s = obs.spans()
    scan = np.flatnonzero(s["name"] == "rx.nc_scan")
    if cfg != 3:
        assert len(scan) == 0
        return
    acq = np.flatnonzero(s["name"] == "rx.acquire")
    assert len(scan) == 1 and s["n"][scan[0]] == 3 and len(acq) == 1
    assert s["start_ns"][acq[0]] <= s["start_ns"][scan[0]]
    assert s["end_ns"][scan[0]] <= s["end_ns"][acq[0]]


def test_scan_agrees_with_the_reference(monkeypatch):
    """Two rows of CONFIG_3 at 0.75 dB: the scan's best lag and score / Lp
    of each CFO-grid row, as the receive computed them, against
    nc_scan.scan_ref / pick_ref on the receive's own segment and bank:
    scores within nc_scan.SCORE_ATOL, delays equal wherever the reference's
    best beats every lag more than one step away by nc_scan.CLEAR_MARGIN
    (the frames' rows are such rows)."""
    g = build_geometry(3)
    seen = []
    real = sync.matched_filter_refine_bank

    def noted(seg, start, bank, window):
        out = real(seg, start, bank, window)
        seen.append((seg, start, bank, window, out))
        return out

    monkeypatch.setattr(sync, "matched_filter_refine_bank", noted)
    pb, _ = _capture(g, 0.75, 2, 5)
    RxChain(g, device="cpu").receive(pb)
    seg, start, bank, window, (delay, score) = seen[0]
    assert (seg.shape[-1], tuple(bank.shape), window) == (
        nc_scan.SEGMENT, nc_scan.BANK, nc_scan.LAGS)
    got = nc_scan.compare(seg, bank, window, delay - start[:, None], score)
    assert got["ok"], got
    assert got["delay_held"] >= 2 and got["pairs"] == 18


def test_fused_pool_delivers_config3_at_threshold():
    """Four channels, a frame each a round at 2 symbols into a chunk of 82
    (the benchmark's c3 cell), Es/N0 0.75 dB, four rounds: from the second
    round (the first arms the pool) every channel is due a frame a round;
    at least 11 of the 12 arrive, each with the bytes its channel sent and
    its delay at the frame's start in the window, sampled up to 8 samples
    early."""
    g = build_geometry(3)
    n_ch, chunk_syms, lead_syms = 4, 82, 2
    pool = serve.FusedDevicePool(g, n_ch, rx=RxChain(g, device="cpu"))
    chunk, lead = chunk_syms * pool.sym_len, lead_syms * pool.sym_len
    start = pool.buf_len - chunk + lead
    tx = TxChain(g, device="cpu")
    rng = np.random.default_rng(0)
    sigma = sim.sigma_for_esn0(0.75)
    delivered = 0
    for r in range(4):
        payloads = rng.integers(0, 256, (n_ch, g.frame_bytes)
                                ).astype(np.uint8)
        frames = tx.transmit(torch.from_numpy(payloads)).numpy()
        block = (sigma * rng.standard_normal((n_ch, chunk))
                 ).astype(np.float32)
        block[:, lead: lead + frames.shape[1]] += frames
        out = pool.unpack(pool.round(block))
        if r == 0:
            assert out == []
            continue
        delivered += len(out)
        for ch, res in out:
            assert bytes(res.payload[0]) == bytes(payloads[ch])
            assert start - 8 <= int(res.delay[0]) <= start
    assert delivered >= 11
