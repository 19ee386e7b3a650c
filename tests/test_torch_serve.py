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
blocks)."""

import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry as jax_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu.scale import serve as jserve
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain
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
