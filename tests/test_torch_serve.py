"""The port's serving pools (`mercury_tpu_torch.scale.serve`) against the
JAX package's, on the CPU, fed the same capture: tests/test_stream.py's two
pool scenarios (CONFIG_16, 4 and 6 channels) decode the same channels to
the same payloads in the same number of batched dispatches, and
FusedDevicePool's packed rows (CONFIG_9, 4 channels, chip_smoke.py's
capture and rounds), round by round, are byte-equal to the JAX pool's in
payload, ok and delay, with iters within +-1 (ROADMAP §3: LDPC sweeps are
not bit-reproducible across frameworks), freq within 0.01 Hz, snr within
0.05 dB (the two estimators differ in the last digits; ROADMAP §3) and the
sync metric within 1e-5 (the two differ by at most 3.6e-7 on these
blocks). The pools' shared result build (`serve._results`) gives what the
per-row construction it replaced gave, with no two results sharing memory;
FusedDevicePool.round issues the next block's upload before the receive
and counts the rounds whose chunk a prefetch gave; the receive's refine
banks are built once a chain, with the results of a chain that builds them
anew each receive; and the three pools, fed the same blocks, deliver the
same frames round by round with the same countdowns."""

import gc

import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry as jax_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu.scale import serve as jserve
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain, RxResult
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import serve

CFG = 16                     # the smallest frame: short CPU receives


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def chains():
    """One chain per package, shared by the module's pools (as a server
    shares one chain between its pools)."""
    return (RxChain(build_geometry(CFG), device="cpu"),
            JaxRx(jax_geometry(CFG)))


def _frames(n_ch: int, rng, cfg: int = CFG) -> tuple[np.ndarray,
                                                      np.ndarray]:
    g = build_geometry(cfg)
    payloads = rng.integers(0, 256, (n_ch, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g, device="cpu").transmit(
        torch.from_numpy(payloads)).numpy()
    return payloads, frames


def _uniform_streams(sym: int, buf_len: int, lead0: int = 2,
                     blk_syms: int = 3):
    """tests/test_stream.py:64's capture: 4 channels, each a frame at a
    lead of (lead0 + c) symbols in white noise, fed in blk_syms-symbol
    blocks."""
    rng = np.random.default_rng(3)
    payloads, frames = _frames(4, rng)
    total = buf_len + 8 * sym
    streams = (2e-3 * rng.standard_normal((4, total))).astype(np.float32)
    for c in range(4):
        lead = (lead0 + c) * sym
        streams[c, lead: lead + frames.shape[1]] += frames[c]
    blk = blk_syms * sym
    blocks = [streams[:, p: p + blk] for p in range(0, total - blk + 1, blk)]
    return payloads, blocks


def _drive_device_pool(pool, blocks):
    got: dict[int, bytes] = {}
    for block in blocks:
        pool.feed_block(block)
        for c, res in pool.step():
            got.setdefault(c, bytes(np.asarray(res.payload)[0]))
        if len(got) == pool.n_channels:
            break
    return got


def test_device_stream_pool_matches_jax(chains):
    rx, jrx = chains
    g = build_geometry(CFG)
    pool = serve.DeviceStreamPool(g, 4, rx=rx)
    jpool = jserve.DeviceStreamPool(jax_geometry(CFG), 4, rx=jrx)
    payloads, blocks = _uniform_streams(pool.sym_len, pool.buf_len)
    got = _drive_device_pool(pool, blocks)
    want = _drive_device_pool(jpool, blocks)
    assert got == want
    assert got == {c: bytes(payloads[c]) for c in range(4)}
    assert pool.batched_dispatches == jpool.batched_dispatches
    assert pool.rows_dispatched == jpool.rows_dispatched
    assert pool.batched_dispatches < 4 * 3
    with pytest.raises(AssertionError):
        pool.feed_block(blocks[0][:, :pool.sym_len + 1])


def test_stream_pool_matches_jax(chains):
    """tests/test_stream.py:100: 6 channels, each fed its whole stream (a
    channel-dependent noise lead-in, then the frame) at once."""
    rx, jrx = chains
    g = build_geometry(CFG)
    pool = serve.StreamPool(g, 6, rx=rx)
    jpool = jserve.StreamPool(jax_geometry(CFG), 6, rx=jrx)
    rng = np.random.default_rng(2)
    payloads, frames = _frames(6, rng)
    for c in range(6):
        lead = 3000 + 257 * c
        stream = (2e-3 * rng.standard_normal(lead + pool.buf_len)
                  ).astype(np.float32)
        stream[lead: lead + frames.shape[1]] += frames[c]
        pool.feed(c, stream)
        jpool.feed(c, stream)
    results = []
    for p in (pool, jpool):
        got: dict[int, bytes] = {}
        for _ in range(40):
            for c, res in p.step():
                got.setdefault(c, bytes(np.asarray(res.payload)[0]))
            if len(got) == 6:
                break
        results.append(got)
    assert results[0] == results[1] == {c: bytes(payloads[c])
                                        for c in range(6)}
    assert pool.batched_dispatches == jpool.batched_dispatches < 6
    assert pool.rows_dispatched == jpool.rows_dispatched


def test_fused_device_pool_matches_jax():
    """Round by round on the same blocks (with next_block prefetch): the
    packed [C, frame_bytes + 21] rows, the unpacked results and the
    countdowns. CONFIG_9 (QPSK 8/16, the bench.py mode) at 12 dB, as in
    chip_smoke.py's pool phase: 17-symbol blocks, frames at leads of
    (1 + c) symbols + 97 c samples, whole in their windows from round 1 on;
    round 0 decodes rows that hold part of a frame, rounds 0-3 are masked
    and round 4, when the 85-symbol countdowns are due, decodes all."""
    g = build_geometry(9)
    pool = serve.FusedDevicePool(g, 4, device="cpu")
    jpool = jserve.FusedDevicePool(jax_geometry(9), 4)
    sym, fb = pool.sym_len, g.frame_bytes
    rng = np.random.default_rng(9)
    payloads, frames = _frames(4, rng, cfg=9)
    n_rounds, blk = 5, 17 * sym
    streams = (sim.sigma_for_esn0(12.0)
               * rng.standard_normal((4, n_rounds * blk))).astype(np.float32)
    for c in range(4):
        lead = (1 + c) * sym + 97 * c
        streams[c, lead: lead + frames.shape[1]] += frames[c]
    blocks = [streams[:, r * blk: (r + 1) * blk] for r in range(n_rounds)]
    decoded: dict[int, bytes] = {}
    for r, block in enumerate(blocks):
        nxt = blocks[r + 1] if r + 1 < len(blocks) else None
        packed = pool.round(block, nxt)
        jpacked = jpool.round(block, nxt)
        ours, theirs = packed.numpy(), np.asarray(jpacked)
        assert ours.dtype == np.uint8 and ours.shape == theirs.shape
        assert ours.shape == (4, fb + 21)
        # payload, ok, delay: byte for byte
        np.testing.assert_array_equal(ours[:, :fb + 5], theirs[:, :fb + 5])
        o_cols = serve._columns(ours, fb)
        t_cols = serve._columns(theirs, fb)
        np.testing.assert_allclose(o_cols[3], t_cols[3], rtol=0, atol=0.01)
        np.testing.assert_allclose(o_cols[4], t_cols[4], rtol=0, atol=0.05)
        assert np.all(np.abs(o_cols[5] - t_cols[5]) <= 1)
        np.testing.assert_allclose(o_cols[6], t_cols[6], rtol=0, atol=1e-5)
        got, want = pool.unpack(packed), jpool.unpack(jpacked)
        assert [c for c, _ in got] == [c for c, _ in want]
        for (c, res), (_c, jres) in zip(got, want):
            np.testing.assert_array_equal(res.payload, jres.payload)
            np.testing.assert_array_equal(res.delay, jres.delay)
            np.testing.assert_allclose(res.sync_metric, jres.sync_metric,
                                       rtol=0, atol=1e-5)
            assert res.payload.dtype == np.uint8
            decoded.setdefault(c, bytes(res.payload[0]))
        np.testing.assert_array_equal(pool.ftr.numpy(), np.asarray(jpool.ftr))
    assert decoded == {c: bytes(payloads[c]) for c in range(4)}
    assert pool.frames_decoded == jpool.frames_decoded == 4
    assert pool.batched_dispatches == jpool.batched_dispatches == n_rounds


def _per_row(chans, cols):
    """The per-row construction the shared build replaced: one RxResult of
    one-row slices for each ok row (mean_h a fresh zero where the columns
    leave it out)."""
    out = []
    for i in range(len(chans)):
        if cols[1][i]:
            fs = [f[i: i + 1] for f in cols]
            if len(fs) < 8:
                fs.append(np.zeros(1, np.float32))
            out.append((int(chans[i]), RxResult(*fs)))
    return out


@pytest.mark.parametrize("form", ["fused", "step"])
@pytest.mark.parametrize("mask", ["all", "none", "mixed"])
def test_results_build_matches_per_row(mask, form):
    """serve._results against the per-row construction, on FusedDevicePool's
    packed columns (rows are channels) and on the step pools' host fields
    (channels given): the same channels in the same order, each field of
    the same shape, dtype and bytes; a write into one result's payload or
    mean_h leaves every other result as it was."""
    rng = np.random.default_rng(5)
    n, fb = 37, 98
    ok = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
          "mixed": rng.random(n) < 0.6}[mask]
    if form == "fused":
        packed = rng.integers(0, 256, (n, fb + 21)).astype(np.uint8)
        packed[:, fb] = ok
        chans = np.arange(n)
        cols = serve._columns(packed, fb)
    else:
        chans = rng.permutation(200)[:n]
        cols = [rng.integers(0, 256, (n, fb)).astype(np.uint8), ok,
                rng.integers(0, 5000, n).astype(np.int32),
                *(rng.standard_normal((2, n)).astype(np.float32)),
                rng.integers(0, 50, n).astype(np.int32),
                *(rng.standard_normal((2, n)).astype(np.float32))]
    got = serve._results(chans, cols)
    want = _per_row(chans, cols)
    assert [c for c, _ in got] == [c for c, _ in want]
    assert len(got) == int(ok.sum())
    for (_, a), (_, b) in zip(got, want):
        for name in RxResult.__dataclass_fields__:
            x, y = getattr(a, name), getattr(b, name)
            assert x.shape == y.shape and x.dtype == y.dtype, name
            assert x.tobytes() == y.tobytes(), name
    before = [[getattr(r, f).copy() for f in ("payload", "mean_h")]
              for _, r in got]
    for k, (_, r) in enumerate(got):
        r.payload[...] = 255 - before[k][0]
        r.mean_h[...] = 1.0 + k
        for j, (_, other) in enumerate(got):
            if j != k:
                assert other.payload.tobytes() == before[j][0].tobytes()
                assert other.mean_h.tobytes() == before[j][1].tobytes()
        r.payload[...] = before[k][0]
        r.mean_h[...] = before[k][1]


@pytest.mark.parametrize("collecting", [True, False])
def test_results_build_leaves_collector_as_found(collecting):
    """The build pauses the cyclic collector and leaves it as it found it,
    on or off."""
    packed = np.zeros((5, 98 + 21), np.uint8)
    packed[:, 98] = 1
    was = gc.isenabled()
    (gc.enable if collecting else gc.disable)()
    try:
        out = serve._results(np.arange(5), serve._columns(packed, 98))
        assert gc.isenabled() == collecting
    finally:
        (gc.enable if was else gc.disable)()
    assert [c for c, _ in out] == list(range(5))


class _StubRx:
    """A receive chain that decodes nothing and notes, at each receive,
    whether its pool already holds the next block's upload."""

    device = torch.device("cpu")

    def __init__(self, frame_bytes: int):
        self.frame_bytes = frame_bytes
        self.pool = None
        self.pending = []

    def receive(self, windows):
        self.pending.append(self.pool._pending is not None)
        b = windows.shape[0]
        z = torch.zeros(b)
        return RxResult(torch.zeros((b, self.frame_bytes), dtype=torch.uint8),
                        torch.zeros(b, dtype=torch.bool),
                        torch.zeros(b, dtype=torch.int32), z, z,
                        torch.zeros(b, dtype=torch.int32), z, z)


def test_fused_round_prefetches_before_receive():
    """round(block, next_block) issues the next upload before it calls the
    receive, and prefetched_rounds counts the rounds whose chunk came from
    a prefetch (not the first round's, nor one after a round without
    next_block)."""
    g = build_geometry(9, with_pre_eq=False)
    stub = _StubRx(g.frame_bytes)
    pool = serve.FusedDevicePool(g, 3, rx=stub)
    stub.pool = pool
    blk = 2 * pool.sym_len
    rng = np.random.default_rng(1)
    blocks = [rng.standard_normal((3, blk)).astype(np.float32)
              for _ in range(4)]
    counts = []
    for r, nxt in enumerate([blocks[1], blocks[2], None, None]):
        pool.round(blocks[r], nxt)
        np.testing.assert_array_equal(pool.windows[:, -blk:].numpy(),
                                      blocks[r])
        counts.append(pool.prefetched_rounds)
    assert stub.pending == [True, True, False, False]
    assert counts == [0, 1, 2, 2]
    assert pool._pending is None


def _capture(cfg: int, rows: int, seed: int) -> np.ndarray:
    """rows receive buffers of CONFIG_cfg, each a frame at a lead of
    (2 + row) symbols in white noise."""
    g = build_geometry(cfg)
    rng = np.random.default_rng(seed)
    _, frames = _frames(rows, rng, cfg=cfg)
    sym = g.nofdm * g.interp
    buf = (2e-3 * rng.standard_normal(
        (rows, g.nofdm * g.buffer_nsymb * g.interp))).astype(np.float32)
    for r in range(rows):
        lead = (2 + r) * sym
        buf[r, lead: lead + frames.shape[1]] += frames[r]
    return buf


@pytest.mark.parametrize("cfg", [9, 3])
def test_refine_bank_built_once_per_chain(cfg, monkeypatch):
    """Over two receives a chain builds its refine banks once (CONFIG_9:
    the alias bank; CONFIG_3: that and the deep-sync grid's), and its
    results are bit-identical to a chain's whose bank cache is emptied
    before each receive."""
    g = build_geometry(cfg)
    kept, fresh = RxChain(g, device="cpu"), RxChain(g, device="cpu")
    calls = []
    real = RxChain._rotated_bank

    def counted(self, *args, **kw):
        if self is kept:
            calls.append(args[1])
        return real(self, *args, **kw)

    monkeypatch.setattr(RxChain, "_rotated_bank", counted)
    for seed in (1, 2):
        pb = torch.from_numpy(_capture(cfg, 2, seed))
        a = kept.receive(pb)
        fresh._bank_cache.clear()
        b = fresh.receive(pb)
        assert a.crc_ok.all()
        for name in RxResult.__dataclass_fields__:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert len(calls) == (1 if cfg == 9 else 2)


def _delivered(out) -> set:
    return {(c, bytes(res.payload[0]), int(res.delay[0])) for c, res in out}


@pytest.mark.parametrize("blk_syms", [3, 17])
def test_pools_agree_round_by_round(blk_syms):
    """The three pools fed the same CONFIG_9 blocks at 12 dB, sharing one
    chain: five channels, a frame each on channels 0 and 1 and noise alone
    on 2-4 (their decodes fail). A first block of a whole window makes every
    channel ready at once; the blocks after it are of blk_syms symbols,
    fewer than IDLE_REARM (the failed channels wait a round) or more (they
    are decoded every round and the delivered ones once their countdown is
    due), so the step pools decode three of five rows (DeviceStreamPool pads
    its bucket with channel 0's window, StreamPool with a zero row) while
    FusedDevicePool decodes and masks every row. Round by round the three
    deliver the same (channel, payload, delay) set, and DeviceStreamPool's
    countdowns equal FusedDevicePool's."""
    g = build_geometry(9)
    rx = RxChain(g, device="cpu")
    fused = serve.FusedDevicePool(g, 5, rx=rx)
    steps = [serve.DeviceStreamPool(g, 5, rx=rx), serve.StreamPool(g, 5, rx=rx)]
    sym = fused.sym_len
    rng = np.random.default_rng(11)
    payloads, frames = _frames(2, rng, cfg=9)
    sigma = sim.sigma_for_esn0(12.0)
    blocks = [(sigma * rng.standard_normal((5, n))).astype(np.float32)
              for n in [fused.buf_len] + [blk_syms * sym] * 3]
    for c in range(2):
        lead = (1 + c) * sym + 97 * c
        blocks[0][c, lead: lead + frames.shape[1]] += frames[c]
    got, rows = [], []
    for block in blocks:
        got.append(_delivered(fused.unpack(fused.round(block))))
        for pool in steps:
            pool.feed_block(block)
            assert _delivered(pool.step()) == got[-1]
        np.testing.assert_array_equal(steps[0]._ftr, fused.ftr.numpy())
        rows.append(steps[0].rows_dispatched)
    assert {(c, p) for c, p, _ in got[0]} == {(c, bytes(payloads[c]))
                                             for c in range(2)}
    assert got[1:] == [set()] * 3
    assert rows[:2] == [5, 5 + 3 * (blk_syms >= serve.IDLE_REARM)]
    assert steps[0].rows_dispatched == steps[1].rows_dispatched
