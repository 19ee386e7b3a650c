"""The MFSK ROBUST modes (CONFIG_100-102) in mercury_tpu_torch against the
JAX package on the same numpy inputs: mfsk.mod and the preamble/pattern
grids (exact), mfsk.demod (float32: atol 1e-4, rtol 1e-4, the clip at
+-clamp exact), sync.mfsk_sync_metric and sync.pattern_detect_metric
(atol 1e-5, rtol 1e-4; the pattern's matched counts equal), the option
policy of the MFSK and control-frame chains, and the receive.

Receive: the JAX chain mixes the decode's frame in float32 phase where the
port reads the float64 oscillator table, so the LLRs differ in the last
digits. Held equal: crc_ok, delay, the payload of every decoded row, the
sync metric within 1e-4, iters within one sweep (ROADMAP.md §3). Batch 2:
a ROBUST_0 buffer holds 705024 samples a row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.core.geometry import mfsk_params as jax_mfsk_params
from mercury_tpu.modem import mfsk as jmfsk
from mercury_tpu.modem import sync as jsync
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu.modem.tx import TxChain as JaxTx
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.core.geometry import mfsk_params
from mercury_tpu_torch.dsp import kernels, ops
from mercury_tpu_torch.modem import mfsk, sync
from mercury_tpu_torch.modem.patterns import PatternSignaler
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

# tests/test_rx.py:127's waterfall + 4 dB, tests/test_mfsk_ctrl.py:14's
# control-frame points (channel SNR, dB)
LOOPBACK_DB = {(100, False): -9.0, (101, False): -7.0, (102, False): -4.0,
               (100, True): -12.0, (101, True): -10.0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """MKL threads tanh on the LDPC's small tensors at a cost far above the
    work; one thread keeps the CPU decodes short."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def chains():
    cache = {}

    def get(cfg, ctrl=False):
        if (cfg, ctrl) not in cache:
            g = build_geometry(cfg)
            cache[cfg, ctrl] = (g, JaxRx(g, ctrl=ctrl),
                                RxChain(port_geometry(cfg), device="cpu",
                                        ctrl=ctrl))
        return cache[cfg, ctrl]

    return get


def mfsk_buffer(g, snr_db: float, seed: int, ctrl: bool = False, b: int = 2):
    """b frames of random payloads at the symbol-aligned delay of
    tests/test_rx.py:137, in white noise at snr_db channel SNR (the MFSK
    convention). -> (buffer float32 [b, n], payload, delay, frames)."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (b, g.frame_bytes)).astype(np.uint8)
    tx = TxChain(port_geometry(g.spec.config), device="cpu", ctrl=ctrl)
    frames = tx.transmit(torch.as_tensor(payload)).numpy()
    sigma = sim.sigma_for_channel_snr(frames[0], snr_db, g.fs, g.bandwidth)
    delay = (g.preamble_nsymb + 2) * g.nofdm * g.interp
    buf = rng.standard_normal((b, g.nofdm * g.buffer_nsymb * g.interp)) * sigma
    buf[:, delay: delay + frames.shape[1]] += frames
    return buf.astype(np.float32), payload, delay, frames


# ---------------------------------------------------------------------------
# mfsk.mod, the grids, mfsk.demod
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,ctrl", [(100, False), (101, False),
                                      (102, False), (100, True), (101, True)])
def test_mod_matches_jax(cfg, ctrl):
    g = build_geometry(cfg)
    nsymb = g.ctrl_nsymb if ctrl else g.nsymb
    nbits = g.spec.ctrl_nbits if ctrl else g.n_bits
    bits = np.random.default_rng(cfg).integers(0, 2, (3, nbits))
    want = np.asarray(jmfsk.mod(jnp.asarray(bits, jnp.int32), g.mfsk, g.nc,
                                nsymb))
    got = mfsk.mod(torch.as_tensor(bits), port_geometry(cfg).mfsk, g.nc,
                   nsymb)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cfg", [100, 101, 102])
def test_grids_match_jax(cfg):
    g, pg = build_geometry(cfg), port_geometry(cfg)
    np.testing.assert_array_equal(
        mfsk.preamble_grid(pg.mfsk, g.nc, g.preamble_nsymb),
        jmfsk.preamble_grid(g.mfsk, g.nc, g.preamble_nsymb))
    # the mode's own tones and the universal ACK/BREAK MFSK's
    for p, pj in ((pg.mfsk, g.mfsk), (mfsk_params(16, g.nc, 1),
                                      jax_mfsk_params(16, g.nc, 1))):
        for tones in (p.ack_tones, p.break_tones):
            np.testing.assert_array_equal(mfsk.pattern_grid(p, g.nc, tones),
                                          jmfsk.pattern_grid(pj, g.nc, tones))


@pytest.mark.parametrize("cfg,soft,pool,exp_scale,clamp", [
    (100, "maxlog", False, 1.0, 5.0), (100, "sumexp", True, 1.0, 5.0),
    (101, "sumexp", False, 1.0, 5.0), (101, "maxlog", True, 1.0, 5.0),
    (102, "sumexp", True, 0.7, 3.0), (100, "maxlog", False, 1.3, 2.5),
])
def test_demod_matches_jax(cfg, soft, pool, exp_scale, clamp):
    """A grid of MFSK symbols in complex noise (~3 dB per tone)."""
    g = build_geometry(cfg)
    rng = np.random.default_rng(cfg)
    bits = rng.integers(0, 2, (2, g.n_bits))
    clean = np.asarray(jmfsk.mod(jnp.asarray(bits, jnp.int32), g.mfsk, g.nc,
                                 g.nsymb))
    grid = (clean + 2.0 * (rng.standard_normal(clean.shape)
                           + 1j * rng.standard_normal(clean.shape))
            ).astype(np.complex64)
    kw = dict(soft=soft, exp_scale=exp_scale, clamp=clamp, noise_pool=pool)
    want = np.asarray(jmfsk.demod(jnp.asarray(grid), g.mfsk, g.nc, g.nsymb,
                                  **kw))
    got = mfsk.demod(torch.as_tensor(grid), port_geometry(cfg).mfsk, g.nc,
                     g.nsymb, **kw).numpy()
    assert got.shape == want.shape == (2, g.n_bits)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    clipped = np.abs(want) == clamp
    assert clipped.any() and np.abs(got).max() == clamp
    np.testing.assert_array_equal(got[clipped], want[clipped])


# ---------------------------------------------------------------------------
# sync metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [100, 101])
def test_mfsk_sync_metric_matches_jax(cfg):
    """On the base-rate time-sync baseband of a noisy buffer (decim =
    interp, as the receive calls it) and on the full-rate one."""
    g = build_geometry(cfg)
    buf, _payload, delay, _f = mfsk_buffer(g, -6.0, cfg, b=1)
    buf = buf[:, : buf.shape[1] // 4]             # ~160 symbols are enough
    pg = port_geometry(cfg)
    iq = torch.as_tensor(buf) * ops.mixer_table(buf.shape[1], g.fc, g.fs,
                                                "cpu")
    taps = torch.as_tensor(g.fir_rx_ts, dtype=torch.float32)
    for decim, bb in ((g.interp, ops.fir_same_strided(iq, taps, g.interp)),
                      (1, ops.fir_same(iq, taps))):
        want = np.asarray(jsync.mfsk_sync_metric(jnp.asarray(bb.numpy()), g,
                                                 decim=decim))
        got = sync.mfsk_sync_metric(bb, pg, decim=decim).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        assert got.argmax() * g.nofdm * g.interp == delay


@pytest.mark.parametrize("cfg", [0, 101])
def test_pattern_detect_metric_matches_jax(cfg):
    """The JAX metric of a full-rate baseband (an ACK pattern in noise,
    mixed and filtered) against the port's of the same (decim 1) and of its
    base-rate samples (decim = interp); a buffer shorter than the pattern
    gives the JAX package's zeros."""
    g, pg = build_geometry(cfg), port_geometry(cfg)
    sig = PatternSignaler(pg, device="cpu")
    p = sig.ack_mfsk
    rng = np.random.default_rng(cfg)
    pat = sig.ack_passband
    delay = 2 * g.nofdm * g.interp
    pb = 0.05 * rng.standard_normal((2, pat.size + 2 * delay))
    pb[:, delay: delay + pat.size] += pat
    iq = torch.as_tensor(pb, dtype=torch.float32) * ops.mixer_table(
        pb.shape[1], g.fc, g.fs, "cpu")
    bb = ops.fir_same(iq, torch.as_tensor(g.fir_rx_data,
                                          dtype=torch.float32)).numpy()
    for tones in (p.ack_tones, p.break_tones):
        met_j, cnt_j = jsync.pattern_detect_metric(jnp.asarray(bb), g, tones, p)
        for decim, x in ((1, bb), (g.interp, bb[:, :: g.interp])):
            met, cnt = sync.pattern_detect_metric(torch.as_tensor(x), pg,
                                                  tones, p, decim=decim)
            np.testing.assert_allclose(met.numpy(), np.asarray(met_j),
                                       atol=1e-5, rtol=1e-4)
            np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    short = bb[:, : 8 * g.nofdm * g.interp]
    met_j, cnt_j = jsync.pattern_detect_metric(jnp.asarray(short), g,
                                               p.ack_tones, p)
    met, cnt = sync.pattern_detect_metric(torch.as_tensor(short), pg,
                                          p.ack_tones, p)
    assert met.shape == cnt.shape == np.asarray(met_j).shape == (2, 1)
    assert not met.any() and not cnt.any()


# ---------------------------------------------------------------------------
# option policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,kwargs,chain", [
    (0, {"ctrl": True}, "tx"), (0, {"ctrl": True}, "rx"),   # OFDM
    (102, {"ctrl": True}, "tx"), (102, {"ctrl": True}, "rx"),
    (100, {"dd": True}, "rx"), (101, {"bicm_iters": 2}, "rx"),
])
def test_option_policy_matches_jax(cfg, kwargs, chain):
    """Each ValueError of the JAX chains for MFSK modes and control frames
    (tests/test_mfsk_ctrl.py:33-45, mercury_tpu/modem/rx.py:76,220,241)."""
    jax_cls, port_cls = {"tx": (JaxTx, TxChain), "rx": (JaxRx, RxChain)}[chain]
    with pytest.raises(ValueError):
        jax_cls(build_geometry(cfg), **kwargs)
    with pytest.raises(ValueError):
        port_cls(port_geometry(cfg), device="cpu", **kwargs)


def test_mfsk_defaults_match_jax(chains):
    """Deep sync, DD and BICM-ID are off on MFSK; the demod options are the
    JAX chain's; the frame sizes of a control frame."""
    for cfg, ctrl in ((100, False), (100, True)):
        g, jax_rx, rx = chains(cfg, ctrl)
        assert (rx.deep_sync, rx.deep_coherent, rx.dd, rx.bicm_iters) == (
            jax_rx.deep_sync, jax_rx.deep_coherent, jax_rx.dd,
            jax_rx.bicm_iters) == (False, False, False, 0)
        assert (rx.mfsk_soft, rx.mfsk_noise_pool, rx.mfsk_sync_cands,
                rx.mfsk_exp_scale, rx.mfsk_clamp) == (
            jax_rx.mfsk_soft, jax_rx.mfsk_noise_pool, jax_rx._mfsk_sync_cands,
            jax_rx.mfsk_exp_scale, jax_rx.mfsk_clamp)
        assert (rx.active_nsymb, rx.active_nbits) == (
            jax_rx.active_nsymb, jax_rx.active_nbits)


# ---------------------------------------------------------------------------
# the receive
# ---------------------------------------------------------------------------

def _assert_same(res, res_j):
    ok = res.crc_ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(res_j.crc_ok))
    np.testing.assert_array_equal(res.delay.numpy(), np.asarray(res_j.delay))
    np.testing.assert_array_equal(res.payload.numpy()[ok],
                                  np.asarray(res_j.payload)[ok])
    assert np.abs(res.iters.numpy() - np.asarray(res_j.iters))[ok].max(
        initial=0) <= 1
    np.testing.assert_allclose(res.sync_metric.numpy(),
                               np.asarray(res_j.sync_metric), atol=1e-4,
                               rtol=1e-4)
    for f in ("freq_offset", "snr_db", "mean_h"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(res_j, f)))


@pytest.mark.parametrize("cfg,ctrl", list(LOOPBACK_DB))
def test_receive_matches_jax(chains, cfg, ctrl):
    """tests/test_rx.py::test_loopback_mfsk's points and
    tests/test_mfsk_ctrl.py's control frames: every row decodes to its
    payload in both packages."""
    g, jax_rx, rx = chains(cfg, ctrl)
    buf, payload, delay, frames = mfsk_buffer(g, LOOPBACK_DB[cfg, ctrl], cfg,
                                              ctrl)
    if ctrl:
        assert frames.shape[1] == (g.nofdm * (g.preamble_nsymb + g.ctrl_nsymb)
                                   * g.interp) < g.total_frame_size
    res = rx.receive(torch.as_tensor(buf))
    _assert_same(res, jax_rx.receive(jnp.asarray(buf)))
    assert res.crc_ok.all() and (res.payload.numpy() == payload).all()
    assert (res.delay.numpy() == delay).all()


def test_second_candidate_matches_jax(chains):
    """Row 0 carries, 40 symbols after its frame, a preamble-only decoy
    twice as strong: the sync picks the decoy, its decode fails, and the
    runner-up (the frame) decodes. Row 1 has no decoy. Both packages return
    the frame's delay, payload and sync metric."""
    g, jax_rx, rx = chains(100)
    buf, payload, delay, frames = mfsk_buffer(g, -6.0, 7)
    pre = frames[0, : g.preamble_nsymb * g.nofdm * g.interp]
    decoy = delay + 40 * g.nofdm * g.interp
    buf[0, decoy: decoy + pre.size] += 2.0 * pre
    rx.reset_recovery()
    res = rx.receive(torch.as_tensor(buf))
    res_j = jax_rx.receive(jnp.asarray(buf))
    assert rx.recovery["mfsk_rows"] == 1          # row 0 only
    _assert_same(res, res_j)
    assert res.crc_ok.all() and (res.payload.numpy() == payload).all()
    assert (res.delay.numpy() == delay).all()
    # the decoy won the sync: its metric exceeds the frame's
    pb = torch.as_tensor(buf)
    met = sync.mfsk_sync_metric(
        kernels.mix_fir_decimate(pb, rx._osc_const(pb.shape[1]), rx._fir_ts,
                                 g.interp), rx.geom, decim=g.interp)
    assert met[0].argmax() * g.nofdm * g.interp == decoy
    assert float(res.sync_metric[0]) < float(met[0].max())


def test_decode_at_matches_jax(chains):
    g, jax_rx, rx = chains(101)
    buf, payload, delay, _f = mfsk_buffer(g, -8.0, 3)
    d = np.full(2, delay, np.int32)
    f = np.zeros(2, np.float32)
    got = rx.decode_at(torch.as_tensor(buf), torch.as_tensor(d),
                       torch.as_tensor(f))
    want = jax_rx.decode_at(jnp.asarray(buf), jnp.asarray(d), jnp.asarray(f))
    for name, a, w in zip(("payload", "crc_ok", "iters", "snr", "mean_h"),
                          got, want):
        w = np.asarray(w)
        if name == "iters":
            assert a.dtype == torch.int32 and np.abs(a.numpy() - w).max() <= 1
        else:
            np.testing.assert_array_equal(a.numpy(), w, err_msg=name)
    assert got[1].all() and (got[0].numpy() == payload).all()
    with pytest.raises(NotImplementedError, match=r"§1, item 13\)"):
        rx.decode_at(torch.as_tensor(buf), torch.as_tensor(d),
                     torch.full((2,), 5.0))
