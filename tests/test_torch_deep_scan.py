"""CONFIG_0's coherent deep acquisition in the port's receive and serving
pool (CPU, plain versions): the span rx.deep_scan carries the rows scanned;
rx.rescue opens only where a row failed its CRC, carries the rows decoded
again and holds the runner-up decode's rx.decode; recording changes no
result; the rescue decodes again only the failed rows with a runner-up,
and every field equals the whole-batch rescue's; the CFO grid is a tensor
on the chain's device, built once a chain; and FusedDevicePool delivers the
port's CONFIG_0 frames at Es/N0 -4.5 dB with the bytes sent, at their known
start."""

import dataclasses

import numpy as np
import pytest
import torch

from mercury_tpu_torch import obs
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.dsp import ops
from mercury_tpu_torch.modem.rx import RxChain, RxResult
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


@pytest.fixture(scope="module")
def geom():
    return build_geometry(0)


@pytest.fixture
def ring():
    """An empty span ring, emptied again after the test."""
    obs.clear()
    yield
    obs.clear()


def _capture(g, kinds, seed: int):
    """[len(kinds), buffer] float32 of CONFIG_0 under white noise, a row
    each kind: "clean" its frame at (2 + r) symbols into row r at Es/N0 6
    dB, "weak" there at -5.5 dB (near threshold), "blank" noise alone at 6
    dB's level, "decoy" at 0 dB a frame at twice the amplitude one symbol
    in whose second half of data symbols is another frame's (its pilots
    intact, its CRC failed), with the row's own frame intact a symbol after
    it, off the decoy's plateau: the first decode takes the decoy, the
    runner-up the frame. -> (buffer, payloads)."""
    rng = np.random.default_rng(seed)
    rows = len(kinds)
    payloads = rng.integers(0, 256, (rows + 2, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g, device="cpu").transmit(
        torch.from_numpy(payloads)).numpy()
    sym = g.nofdm * g.interp
    flen = frames.shape[1]
    pre = g.preamble_nsymb * sym
    cut = pre + (flen - pre) // sym // 2 * sym
    n = g.nofdm * g.buffer_nsymb * g.interp
    esn0 = {"clean": 6.0, "blank": 6.0, "weak": -5.5, "decoy": 0.0}
    buf = np.empty((rows, n), np.float32)
    for r, kind in enumerate(kinds):
        buf[r] = sim.sigma_for_esn0(esn0[kind]) * rng.standard_normal(n)
        lead = (2 + r) * sym
        if kind == "decoy":
            decoy = np.concatenate([frames[rows][:cut], frames[rows + 1][cut:]])
            buf[r, sym: sym + flen] += 2.0 * decoy
            lead = 2 * sym + flen
        if kind != "blank":
            buf[r, lead: lead + flen] += frames[r]
    return torch.from_numpy(buf), payloads[:rows]


def _names(s):
    return [str(x) for x in s["name"]]


@pytest.mark.parametrize("blank", [(), (1,)])
def test_deep_scan_and_rescue_spans(geom, ring, blank):
    """Three rows at 6 dB: the scan's span inside rx.acquire, n = 3; with a
    row of noise alone (its CRC fails) one rx.rescue, n = 1 (only that row
    is decoded again), after the first decode and around the runner-up's
    rx.decode; with every row clean none. The results equal a receive's
    with the recorder off."""
    rx = RxChain(geom, device="cpu")
    pb, payloads = _capture(
        geom, ["blank" if r in blank else "clean" for r in range(3)], 11)
    off = rx.receive(pb)
    assert obs.spans()["name"].size == 0
    with obs.recording():
        on = rx.receive(pb)
    for f in dataclasses.fields(on):
        assert torch.equal(getattr(on, f.name), getattr(off, f.name)), f.name
    ok = on.crc_ok.numpy()
    assert ok.tolist() == [r not in blank for r in range(3)]
    for r in np.flatnonzero(ok):
        assert bytes(on.payload[r].numpy()) == bytes(payloads[r])
    s = obs.spans()
    names = _names(s)
    scan = np.flatnonzero(s["name"] == "rx.deep_scan")
    acq = names.index("rx.acquire")
    assert len(scan) == 1 and s["n"][scan[0]] == 3
    assert s["start_ns"][acq] <= s["start_ns"][scan[0]]
    assert s["end_ns"][scan[0]] <= s["end_ns"][acq]
    rescue = np.flatnonzero(s["name"] == "rx.rescue")
    decodes = np.flatnonzero(s["name"] == "rx.decode")
    if not blank:
        assert len(rescue) == 0 and len(decodes) == 1
        return
    assert len(rescue) == 1 and s["n"][rescue[0]] == 1
    assert len(decodes) == 2
    first, second = decodes
    assert s["end_ns"][first] <= s["start_ns"][rescue[0]]
    assert s["start_ns"][rescue[0]] <= s["start_ns"][second]
    assert s["end_ns"][second] <= s["end_ns"][rescue[0]]


def _whole_batch_rescue(rx, pb):
    """The rescue as it decoded the whole batch: every row decoded again at
    its runner-up (delay, CFO), and a row takes that result where its own
    CRC failed, the runner-up's passed and it had a runner-up. -> (RxResult,
    the first decode's crc_ok, eligible)."""
    with torch.no_grad(), ops.full_fp32_matmul():
        delay, cfo, metric, (delay2, cfo2, have2) = rx._acquire(pb)
        out = rx._decode_from(pb, delay, cfo, metric)
        out2 = rx._decode_from(pb, delay2, cfo2, metric)
    use2 = ~out.crc_ok & out2.crc_ok & have2
    merged = {}
    for f in dataclasses.fields(RxResult):
        a1, a2 = getattr(out, f.name), getattr(out2, f.name)
        merged[f.name] = torch.where(
            use2.reshape((-1,) + (1,) * (a1.ndim - 1)), a2, a1)
    return RxResult(**merged), out.crc_ok, have2, use2


@pytest.mark.parametrize("kinds,no_runner_up", [
    (("clean", "blank", "weak", "weak", "decoy", "clean", "weak", "blank"),
     (7,)),
    (("clean", "clean", "clean"), ()),
    (("decoy",), ()),
], ids=["mixed", "clean", "one_failed_row"])
def test_rescue_decodes_only_the_failed_rows(geom, monkeypatch, kinds,
                                             no_runner_up):
    """Every field of the receive equals the whole-batch rescue's, bit for
    bit; the second decode is called with exactly the rows whose first CRC
    failed and that have a runner-up (no second decode where there are
    none), at their runner-up delays; and each decoy row takes the
    runner-up's result, its own frame's bytes. In the mixed batch (seed 3)
    one weak row fails and is not rescued, and the acquisition is made to
    report no runner-up for the last blank row, which then is not decoded
    again."""
    rx = RxChain(geom, device="cpu")
    acquire = RxChain._coherent_acquire

    def without_runner_up(self, *args, **kw):
        acq = acquire(self, *args, **kw)
        if len(acq) != 5:
            return acq
        have2 = acq[4].clone()
        have2[list(no_runner_up)] = False
        return (*acq[:4], have2)

    monkeypatch.setattr(RxChain, "_coherent_acquire", without_runner_up)
    pb, payloads = _capture(geom, kinds, 3)
    ref, first_ok, have2, use2 = _whole_batch_rescue(rx, pb)
    decoys = [r for r, k in enumerate(kinds) if k == "decoy"]
    assert use2.numpy()[decoys].all()
    assert not first_ok.numpy()[list(no_runner_up)].any()
    calls = []
    real = RxChain._decode_from

    def recorded(self, pb_rows, delay, *args, **kw):
        calls.append((pb_rows, delay))
        return real(self, pb_rows, delay, *args, **kw)

    monkeypatch.setattr(RxChain, "_decode_from", recorded)
    got = rx.receive(pb)
    for f in dataclasses.fields(RxResult):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name
    for r in decoys:
        assert bytes(got.payload[r].numpy()) == bytes(payloads[r])
    rows = torch.nonzero(~first_ok & have2)[:, 0]
    assert len(calls) == (2 if rows.numel() else 1)
    assert torch.equal(calls[0][0], pb)
    if rows.numel():
        with torch.no_grad(), ops.full_fp32_matmul():
            delay2 = rx._acquire(pb)[3][0]
        assert torch.equal(calls[1][0], pb[rows])
        assert torch.equal(calls[1][1], delay2[rows])


def test_cfo_grid_built_once_on_the_chains_device(geom, monkeypatch):
    """Two receives build the coherent banks once: the grid is a tensor of
    the chain's real type on its device, the same object both times, and
    the banks' two rotations run once."""
    rx = RxChain(geom, device="cpu")
    calls = []
    real = RxChain._rotated_bank

    def counted(self, *args, **kw):
        calls.append(args[1])
        return real(self, *args, **kw)

    monkeypatch.setattr(RxChain, "_rotated_bank", counted)
    grids = []
    for seed in (1, 2):
        pb, _ = _capture(geom, ("clean", "clean"), seed)
        assert rx.receive(pb).crc_ok.all()
        grids.append(rx._coherent_banks(8)[0])
    assert grids[0] is grids[1]
    grid = grids[0]
    assert torch.is_tensor(grid) and grid.device == rx.device
    assert grid.dtype == rx.real_dtype and grid.shape == (61,)
    np.testing.assert_array_equal(grid.numpy(), np.arange(-30, 31) * 4.0)
    assert len(calls) == 2


def test_fused_pool_delivers_config0_at_threshold(geom):
    """Four channels, a frame each a round at 2 symbols into a chunk of 82
    (the benchmark's c0 cell), Es/N0 -4.5 dB, four rounds: from the second
    round (the first arms the pool) every channel is due a frame a round;
    at least 11 of the 12 arrive, each with the bytes its channel sent and
    its delay at the frame's start in the window, sampled up to 8 samples
    early."""
    n_ch, chunk_syms, lead_syms = 4, 82, 2
    pool = serve.FusedDevicePool(geom, n_ch, rx=RxChain(geom, device="cpu"))
    chunk, lead = chunk_syms * pool.sym_len, lead_syms * pool.sym_len
    start = pool.buf_len - chunk + lead
    tx = TxChain(geom, device="cpu")
    rng = np.random.default_rng(0)
    sigma = sim.sigma_for_esn0(-4.5)
    delivered = 0
    for r in range(4):
        payloads = rng.integers(0, 256, (n_ch, geom.frame_bytes)
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
