"""The ported receive as a whole: mercury_tpu_torch RxChain.receive against
mercury_tpu RxChain.receive on the same capture buffers (the TX frame at
the bench.py delay plus one shared numpy noise array), at CONFIG_3 (BPSK
4/16 with automatic deep sync), CONFIG_9 (QPSK 8/16), CONFIG_11 (8PSK, DD
on), CONFIG_13 (16QAM, DD and the MER SNR), CONFIG_16 (32QAM, DD, BICM-ID
and the MER SNR) and, with the zero-forcing estimator, CONFIG_15 and 16.

Equal: crc_ok, delay, iters, and the payload of every row that decodes.
A row that fails to decode ends in the chaotic state of a non-converging
50-sweep LDPC iteration; its garbage payload depends on last-ulp
differences between XLA's and PyTorch's tanh/atanh and is not compared
(test_torch_ldpc.py). freq_offset within 0.5 Hz, snr_db within 0.1 dB.
Near CONFIG_16's threshold (test_torch_bicm.py) the rows whose first
decode fails go through BICM-ID and DD from that chaotic state: for them
iters is held above the first decode's cap only, and snr_db (the MER of
their decisions) only on rows that decode; a row whose first decode
converged keeps iters within one sweep (test_torch_ldpc.py).

The MFSK receive is held against the JAX chain's in test_torch_mfsk.py;
here: the golden buffers of CONFIG_100-102, the carried-across state of
CONFIG_100, the result's dtypes, and the process-wide matmul precision
under two receiving threads."""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.core.modes import HIGH_DENSITY, LOW_DENSITY
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.convert import RX_BUFFERS, rx_state_from_numpy
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem import rx as rx_mod
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

B = 4


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

    def get(cfg, estimator="auto"):
        if (cfg, estimator) not in cache:
            g = build_geometry(cfg, estimator=estimator)
            cache[cfg, estimator] = (
                g, JaxRx(g),
                RxChain(port_geometry(cfg, estimator=estimator),
                        device="cpu"))
        return cache[cfg, estimator]

    return get


def _buffer(g, esn0: float, seed: int, b: int = B):
    """b frames at the bench.py delay in white noise at Es/N0 esn0; an MFSK
    mode's at a symbol-aligned delay, esn0 then the channel SNR."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (b, g.frame_bytes)).astype(np.uint8)
    tx = TxChain(port_geometry(g.spec.config), device="cpu")
    frames = tx.transmit(torch.as_tensor(payload)).numpy()
    n = g.nofdm * g.buffer_nsymb * g.interp
    if g.spec.is_mfsk:
        delay = (g.preamble_nsymb + 2) * g.nofdm * g.interp
        sigma = sim.sigma_for_channel_snr(frames[0], esn0, g.fs, g.bandwidth)
    else:
        delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
        sigma = sim.sigma_for_esn0(esn0)
    buf = rng.standard_normal((b, n)) * sigma
    buf[:, delay: delay + frames.shape[1]] += frames
    return buf.astype(np.float32), payload, delay


def _assert_same(res, res_j, recovery: bool = False):
    """recovery: rows past the first decode's cap went through BICM-ID/DD
    from a chaotic state (module docstring)."""
    ok = res.crc_ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(res_j.crc_ok))
    np.testing.assert_array_equal(res.delay.numpy(), np.asarray(res_j.delay))
    iters, iters_j = res.iters.numpy(), np.asarray(res_j.iters)
    snr, snr_j = res.snr_db.numpy(), np.asarray(res_j.snr_db)
    if recovery:
        first = iters_j <= 50
        assert np.abs(iters - iters_j)[first].max(initial=0) <= 1
        assert (iters[~first] > 50).all()
        snr, snr_j = snr[ok], snr_j[ok]
    else:
        np.testing.assert_array_equal(iters, iters_j)
    np.testing.assert_array_equal(res.payload.numpy()[ok],
                                  np.asarray(res_j.payload)[ok])
    np.testing.assert_allclose(res.freq_offset.numpy(),
                               np.asarray(res_j.freq_offset), atol=0.5)
    np.testing.assert_allclose(snr, snr_j, atol=0.1)


@pytest.mark.parametrize("cfg,esn0,all_ok", [
    (3, 12.0, True), (9, 12.0, True),
    (3, -0.5, False),            # near CONFIG_3's threshold: some rows fail
])
def test_receive_matches_jax(chains, cfg, esn0, all_ok):
    check_receive(chains(cfg), esn0, all_ok)


def check_receive(chain, esn0, all_ok, b=B):
    """Port and JAX receive of one buffer (seed: the config): equal as
    _assert_same says, the decoded rows carry the payloads sent, and every
    delay is within a GI of the true start. b != B marks a near-threshold
    buffer (_assert_same's recovery)."""
    g, jax_rx, rx = chain
    buf, payload, delay = _buffer(g, esn0, seed=g.spec.config, b=b)
    res = rx.receive(torch.as_tensor(buf))
    res_j = jax_rx.receive(jnp.asarray(buf))
    _assert_same(res, res_j, recovery=b != B)
    ok = res.crc_ok.numpy()
    assert ok.all() == all_ok and ok.any()
    assert (res.payload.numpy()[ok] == payload[ok]).all()
    assert (np.abs(res.delay.numpy() - delay) <= g.ngi * g.interp).all()
    return res


# tests/test_rx.py:64's clean points
@pytest.mark.parametrize("cfg,esn0,estimator", [
    (11, 14.0, "auto"), (13, 17.0, "auto"), (16, 31.0, "auto"),
    (15, 27.0, "reference"), (16, 31.0, "reference"),
])
def test_receive_top_of_ladder_matches_jax(chains, cfg, esn0, estimator):
    check_receive(chains(cfg, estimator), esn0, True)


@pytest.mark.parametrize("cfg", [3, 9])
def test_decodes_reference_buffer(golden, cfg):
    check_golden(golden, cfg, HIGH_DENSITY, "auto")


def check_golden(golden, cfg, density, estimator):
    """The chain constructs with default options and decodes the
    reference's capture buffer to its bytes."""
    rx = RxChain(port_geometry(cfg, density, estimator=estimator),
                 device="cpu")
    tag = f"cfg{cfg}ld" if density == LOW_DENSITY else f"cfg{cfg}"
    res = rx.receive(torch.as_tensor(golden(f"{tag}_rx_buffer")[None]))
    assert bool(res.crc_ok[0])
    assert (res.payload[0].numpy()
            == golden(f"{tag}_rx_bytes").astype(np.uint8)).all()
    assert res.snr_db[0].item() >= golden(f"{tag}_rx_snr")[0] - 0.75


# every config at both pilot densities, and zero-forcing on CONFIG_15/16
# (CONFIG_3 and 9 at high density are the test above)
ALL_CFGS = list(range(17)) + [100, 101, 102]
GOLDEN = ([(cfg, HIGH_DENSITY, "auto") for cfg in ALL_CFGS
           if cfg not in (3, 9)]
          + [(cfg, LOW_DENSITY, "auto") for cfg in ALL_CFGS]
          + [(15, HIGH_DENSITY, "reference"), (16, HIGH_DENSITY, "reference")])


@pytest.mark.parametrize("cfg,density,estimator", GOLDEN)
def test_decodes_reference_buffer_every_mode(golden, cfg, density,
                                             estimator):
    check_golden(golden, cfg, density, estimator)


# CONFIG_9 at 12 dB Es/N0; CONFIG_100 at -9 dB channel SNR (its
# waterfall + 4 dB, tests/test_rx.py:135), batch 2 (705024 samples a row)
@pytest.mark.parametrize("cfg,esn0,b", [(9, 12.0, B), (100, -9.0, 2)])
def test_state_carried_across_from_jax(chains, cfg, esn0, b):
    check_state_carried(chains(cfg), esn0, b)


# tests/test_rx.py:64's clean points
@pytest.mark.parametrize("cfg,estimator,esn0", [(16, "auto", 31.0),
                                                (15, "reference", 27.0)])
def test_state_carried_across_top_of_ladder(chains, cfg, estimator, esn0):
    """With the DD constants (CONFIG_16) and the zero-forcing ones."""
    check_state_carried(chains(cfg, estimator), esn0)


def check_state_carried(chain, esn0, b=B):
    """The JAX chain's host constants, converted, equal the port's own
    buffers, load into a port chain and give the same receive results on
    one buffer at esn0 dB."""
    g, jax_rx, rx = chain
    state = rx_state_from_numpy(
        {name: np.asarray(getattr(jax_rx, name)) for name in RX_BUFFERS
         if hasattr(jax_rx, name)}, device="cpu")
    own = rx.state_dict()
    assert set(own) == set(state)
    for name, t in state.items():
        assert t.dtype == own[name].dtype and torch.equal(t, own[name]), name
    fresh = RxChain(rx.geom, device="cpu")
    for t in fresh.state_dict().values():
        t.zero_()
    fresh.load_state_dict(state)
    buf, _payload, _delay = _buffer(g, esn0, seed=1, b=b)
    a, b = rx.receive(torch.as_tensor(buf)), fresh.receive(torch.as_tensor(buf))
    for field in ("payload", "crc_ok", "delay", "freq_offset", "snr_db",
                  "iters"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_mix_and_grid_stats_match_jax(chains):
    g, jax_rx, rx = chains(9)
    buf, _payload, delay = _buffer(g, 12.0, seed=2)
    pb = torch.as_tensor(buf)
    freq = np.array([0.0, 3.5, -20.0, 61.0], np.float32)
    np.testing.assert_allclose(
        rx.mix(pb, torch.as_tensor(freq)).numpy(),
        np.asarray(jax_rx.mix(jnp.asarray(buf), jnp.asarray(freq))),
        atol=1e-5, rtol=1e-4)
    dec = rx.extract_frame_decimated_pb(pb, torch.full((B,), delay - 8),
                                        g.nsymb)
    grid = rx.demod_grid(dec)
    grid_j = jax_rx.demod_grid(jnp.asarray(dec.numpy()))
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_j), atol=1e-5,
                               rtol=1e-4)
    for got, want in zip(rx.grid_stats(grid), jax_rx.grid_stats(grid_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


# the cases that named items 9, 10 and 13 now construct: their options are
# held against the JAX chain's by test_torch_dd.py::test_option_policy_* and
# test_narrow_receive_matches_jax
@pytest.mark.parametrize("cfg,kwargs,item", [
    (0, {"deep_profile": "full"}, "item 8a"),   # round-3 deep scan
    (3, {"deep_profile": "c2f"}, "item 8a"),
])
def test_out_of_slice_options_raise(cfg, kwargs, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md §1, {item}\\)"):
        RxChain(port_geometry(cfg), device="cpu", **kwargs)


@pytest.mark.parametrize("ldpc_algo", ["spa", "minsum", "layered",
                                       "layered-minsum"])
def test_every_ldpc_algo_receives(ldpc_algo):
    """Each decoder the JAX chain accepts serves receive (the decoders
    themselves are held against the JAX ones in test_torch_ldpc.py)."""
    g = build_geometry(13)
    rx = RxChain(port_geometry(13), device="cpu", ldpc_algo=ldpc_algo)
    buf, payload, _delay = _buffer(g, 17.0, seed=5)
    res = rx.receive(torch.as_tensor(buf))
    assert res.crc_ok.all() and (res.payload.numpy() == payload).all()


def test_ctrl_outside_robust_raises():
    """Control frames exist on ROBUST_0/1 only: ValueError on an OFDM mode,
    as the JAX RxChain raises (tests/test_mfsk_ctrl.py:33)."""
    with pytest.raises(ValueError):
        JaxRx(build_geometry(9), ctrl=True)
    with pytest.raises(ValueError, match="ROBUST_0/ROBUST_1"):
        RxChain(port_geometry(9), device="cpu", ctrl=True)


@pytest.mark.parametrize("cfg,esn0", [(9, 12.0), (100, -9.0)])
def test_result_dtypes_match_jax(chains, cfg, esn0):
    """Every RxResult field has the JAX chain's dtype: delay and iters
    int32."""
    g, jax_rx, rx = chains(cfg)
    buf, _payload, _delay = _buffer(g, esn0, seed=2, b=2)
    res = rx.receive(torch.as_tensor(buf))
    res_j = jax_rx.receive(jnp.asarray(buf))
    for f in dataclasses.fields(res):
        got = getattr(res, f.name)
        want = np.asarray(getattr(res_j, f.name)).dtype
        assert str(got.dtype).removeprefix("torch.") == str(want), f.name
    assert res.delay.dtype == res.iters.dtype == torch.int32


def test_matmul_precision_survives_two_threads():
    """Thread A enters the receive's full-precision block, thread B enters,
    A leaves: inside B the precision is still "highest"; after both leave
    it is the caller's own setting again."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    a_in, b_in, a_out, b_checked = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with rx_mod._full_fp32_matmul():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with rx_mod._full_fp32_matmul():
            b_in.set()
            a_out.wait(10)
            seen["inside_b"] = torch.get_float32_matmul_precision()
        b_checked.set()

    try:
        threads = [threading.Thread(target=thread_a),
                   threading.Thread(target=thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert b_checked.is_set()
        assert seen["inside_b"] == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def _cfo_buffer(g, esn0: float, seed: int, offsets):
    """One frame a row at the bench.py delay, row b shifted by offsets[b]
    Hz (sim.apply_cfo), in white noise at Es/N0 esn0 -> (buffer, payload,
    delay, the offsets as applied: rounded to a bin of the frame's FFT)."""
    rng = np.random.default_rng(seed)
    b = len(offsets)
    payload = rng.integers(0, 256, (b, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(port_geometry(g.spec.config), device="cpu").transmit(
        torch.as_tensor(payload))
    frames = torch.cat([sim.apply_cfo(frames[i: i + 1], g.fs, g.fc, f)
                        for i, f in enumerate(offsets)]).numpy()
    n = g.nofdm * g.buffer_nsymb * g.interp
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = rng.standard_normal((b, n)) * sim.sigma_for_esn0(esn0)
    buf[:, delay: delay + frames.shape[1]] += frames
    f_len = frames.shape[1]
    applied = np.array([round(f * f_len / g.fs) * g.fs / f_len
                        for f in offsets], np.float32)
    return buf.astype(np.float32), payload, delay, applied


def test_to_baseband_measure_and_extract_match_jax(chains):
    """to_baseband (both FIRs; at fc, and at per-row offsets, where JAX's
    float32 phase of up to 1.9e4 rad costs ~1.1e-3 rad: 3e-3 of the output
    scale), measure_signal_dbm within 0.01 dB and extract_frame on a
    CONFIG_9 buffer, against the JAX chain."""
    g, jax_rx, rx = chains(9)
    buf, _payload, delay = _buffer(g, 12.0, seed=6, b=3)
    pb, pb_j = torch.as_tensor(buf), jnp.asarray(buf)
    freq = np.array([0.0, 20.0, -45.0], np.float32)
    for data_fir in (True, False):
        np.testing.assert_allclose(
            rx.to_baseband(pb, 0.0, data_fir).numpy(),
            np.asarray(jax_rx.to_baseband(pb_j, 0.0, data_fir)),
            atol=1e-5, rtol=1e-4)
        want = np.asarray(jax_rx.to_baseband(pb_j, jnp.asarray(freq),
                                             data_fir))
        np.testing.assert_allclose(
            rx.to_baseband(pb, torch.as_tensor(freq), data_fir).numpy(), want,
            atol=3e-3 * np.abs(want).max())
    np.testing.assert_allclose(rx.measure_signal_dbm(pb).numpy(),
                               np.asarray(jax_rx.measure_signal_dbm(pb_j)),
                               atol=0.01)
    bb = rx.to_baseband(pb, 0.0)
    d = np.array([delay - 8, 0, buf.shape[1]], np.int64)
    np.testing.assert_allclose(
        rx.extract_frame(bb, torch.as_tensor(d)).numpy(),
        np.asarray(jax_rx.extract_frame(jnp.asarray(bb.numpy()),
                                        jnp.asarray(d, jnp.int32))),
        rtol=0, atol=0)


def test_extract_frame_decimated_iq_matches_jax(chains):
    """extract_frame_decimated over complex IQ (one array for both
    packages) against the JAX chain's at a frame delay, at 0, and at delays
    clipped at both ends, float32 FIRs: within 1e-5 + 1e-4 relative."""
    g, jax_rx, rx = chains(9)
    buf, _payload, delay = _buffer(g, 12.0, seed=7, b=4)
    iq = rx.mix(torch.as_tensor(buf))
    d = np.array([delay - 8, 0, -40, buf.shape[1]], np.int64)
    want = np.asarray(jax_rx.extract_frame_decimated(
        jnp.asarray(iq.numpy()), jnp.asarray(d, jnp.int32), g.nsymb))
    got = rx.extract_frame_decimated(iq, torch.as_tensor(d), g.nsymb)
    assert got.shape == want.shape == (
        4, (g.nsymb + g.preamble_nsymb) * g.nofdm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("cfg,estimator,esn0", [
    (9, "auto", 12.0), (0, "auto", 4.0), (13, "auto", 17.0),
    (16, "reference", 31.0)])
def test_decode_at_ofdm_matches_jax(chains, cfg, estimator, esn0):
    """OFDM decode_at at the known delay - 8 and each row's offset (0,
    +-20 Hz, as applied) against the JAX chain: payload and crc_ok equal, iters
    within one sweep, snr_db within 0.05 dB and mean_h within 1e-3
    (relative). The JAX chain mixes in float32 phase (~1e-3 rad at these
    buffer lengths), the port in float64 (ROADMAP §3)."""
    g, jax_rx, rx = chains(cfg, estimator)
    buf, payload, delay, f = _cfo_buffer(g, esn0, seed=cfg,
                                         offsets=[0.0, 20.0, -20.0])
    d = np.full(3, delay - 8, np.int32)
    got = rx.decode_at(torch.as_tensor(buf), torch.as_tensor(d),
                       torch.as_tensor(f))
    want = jax_rx.decode_at_jit(jnp.asarray(buf), jnp.asarray(d),
                                jnp.asarray(f))
    payload_p, ok, iters, snr, mean_h = (t.numpy() for t in got)
    assert ok.all()
    np.testing.assert_array_equal(ok, np.asarray(want[1]))
    np.testing.assert_array_equal(payload_p, np.asarray(want[0]))
    assert (payload_p == payload).all()
    assert np.abs(iters - np.asarray(want[2])).max() <= 1
    np.testing.assert_allclose(snr, np.asarray(want[3]), atol=0.05)
    np.testing.assert_allclose(mean_h, np.asarray(want[4]), rtol=1e-3)


def test_refine_decode_matches_jax(chains):
    """refine_decode on sibling rows cut as link/node.py:483-496 cuts them
    (transmit_batch frames back to back, each later frame drifted by 37
    more samples, +20 Hz on the air, margin 256): refined delays and
    payloads equal the JAX refine_decode_jit's, every row decodes."""
    g, jax_rx, rx = chains(9)
    rng = np.random.default_rng(21)
    payload = rng.integers(0, 256, (3, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(port_geometry(9), device="cpu").transmit_batch(
        torch.as_tensor(payload))
    f_len = frames.shape[1]
    lead, drift, margin = 5000, 37, 256
    air = torch.zeros(lead + 3 * f_len + 3 * drift + 20000)
    for k in range(3):
        at = lead + k * (f_len + drift)
        air[at: at + f_len] = frames[k]
    air = sim.apply_cfo(air[None], g.fs, g.fc, 20.0)[0].numpy()
    air = (air + 0.02 * rng.standard_normal(air.shape)).astype(np.float32)
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    rows = np.zeros((3, buf_len), np.float32)
    for k in range(3):
        start = lead + k * f_len - margin
        src = air[start: start + buf_len]
        rows[k, : len(src)] = src
    delays = np.full(3, margin, np.int32)
    freqs = np.full(3, 20.0, np.float32)
    got = rx.refine_decode(torch.as_tensor(rows), torch.as_tensor(delays),
                           torch.as_tensor(freqs), margin)
    want = jax_rx.refine_decode_jit(jnp.asarray(rows), jnp.asarray(delays),
                                    jnp.asarray(freqs), margin)
    assert got[1].all() and np.asarray(want[1]).all()
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[0].numpy() == payload).all()
    np.testing.assert_array_equal(got[5].numpy(),
                                  margin + drift * np.arange(3))
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]),
                               rtol=1e-3)


@pytest.mark.parametrize("cfg", [9, 0])
def test_narrow_receive_matches_jax(cfg):
    """cfo_range="narrow" (2 Schmidl-Cox candidates, no alias, 2 CFO
    hypotheses, narrower deep grids) at +30 and -30 Hz against the JAX
    chain's narrow receive: equal as _assert_same says, every row decodes
    its payload."""
    g = build_geometry(cfg)
    rx = RxChain(port_geometry(cfg), device="cpu", cfo_range="narrow")
    buf, payload, _delay, _f = _cfo_buffer(g, 12.0, seed=30 + cfg,
                                           offsets=[30.0, -30.0])
    res = rx.receive(torch.as_tensor(buf))
    res_j = JaxRx(g, cfo_range="narrow").receive(jnp.asarray(buf))
    _assert_same(res, res_j)
    assert res.crc_ok.all()
    assert (res.payload.numpy() == payload).all()
    np.testing.assert_allclose(res.freq_offset.numpy(), [30.0, -30.0],
                               atol=1.0)
