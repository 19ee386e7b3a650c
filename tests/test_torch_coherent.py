"""CONFIG_0's coherent deep acquisition in mercury_tpu_torch against the JAX
package: the max-reduced scan (plain version of the `deep_mf_max` kernel)
against sync.coherent_scan_max with its Pallas kernel in interpret mode and
on its XLA path, topk_pooled's tie order, and RxChain.receive at CONFIG_0
with the CRC-gated rescue decode, on the same capture buffers.

Tolerances: smax rtol/atol 2e-4 (FFT correlations in another order, the bar
tests/test_pilot_kernel.py holds the Pallas kernel to); sarg equal wherever
the best hypothesis leads the runner-up by more than 1e-3. The receive is
held to tests/test_torch_rx.py's rules (crc_ok, delay, iters and decoded
payloads equal; freq_offset within 0.5 Hz, snr_db within 0.1 dB)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem import sync as jsync
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.convert import RX_BUFFERS, rx_state_from_numpy
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.modem import sync
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

B = 4


def _scan_case():
    """tests/test_pilot_kernel.py:46-66: 5 CFO-rotated rows of a 2-symbol
    template against 3 noise rows, lags 0..1400."""
    rng = np.random.default_rng(5)
    b, a, lp, s_d = 3, 5, 2, 136
    seg_len = 2 * 700 + lp * s_d
    seg = (rng.standard_normal((b, seg_len))
           + 1j * rng.standard_normal((b, seg_len))).astype(np.complex64)
    base = (rng.standard_normal((lp, s_d))
            + 1j * rng.standard_normal((lp, s_d))).astype(np.complex64)
    t = np.arange(s_d)
    bank = np.stack([base * np.exp(-1j * 2 * np.pi * f * 2e-4 * t)[None]
                     for f in range(a)]).astype(np.complex64)
    return seg, bank, 700


def _margin(score: np.ndarray) -> np.ndarray:
    top2 = np.sort(score, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("use_pallas", [True, False])
def test_coherent_scan_max_matches_jax(use_pallas):
    seg, bank, window = _scan_case()
    want_max, want_arg = (np.asarray(x) for x in jsync.coherent_scan_max(
        jnp.asarray(seg), bank, window, use_pallas=use_pallas))
    got_max, got_arg = (x.numpy() for x in sync.coherent_scan_max(
        torch.as_tensor(seg), torch.as_tensor(bank), window))
    ref_max, ref_arg = (x.numpy() for x in kernels.deep_mf_max_ref(
        torch.as_tensor(seg), torch.as_tensor(bank), window))
    np.testing.assert_array_equal(got_max, ref_max)
    np.testing.assert_array_equal(got_arg, ref_arg)
    assert got_max.shape == want_max.shape == (3, 2 * window + 1)
    np.testing.assert_allclose(got_max, want_max, rtol=2e-4, atol=2e-4)
    score = np.asarray(jsync.bank_scores(jnp.asarray(seg), bank, window))
    clear = _margin(score) > 1e-3
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_arg[clear], want_arg[clear])
    # elsewhere two hypotheses tie within tolerance (the reference test's bar)
    assert (got_arg == want_arg).mean() > 0.99


def test_deep_mf_max_ref_chunks_keep_first_hypothesis():
    """Across the plain version's hypothesis chunks the first row reaching
    the max wins: a bank of identical rows gives sarg 0 everywhere."""
    seg, bank, window = _scan_case()
    same = np.repeat(bank[:1], 2 * kernels._MAX_CHUNK + 3, axis=0)
    smax, sarg = kernels.deep_mf_max_ref(torch.as_tensor(seg),
                                         torch.as_tensor(same), window)
    assert (sarg == 0).all()
    one = kernels.deep_mf_score_ref(torch.as_tensor(seg),
                                    torch.as_tensor(bank[:1]), window)[:, 0]
    torch.testing.assert_close(smax, one, rtol=0, atol=0)


@pytest.mark.parametrize("start", [0, 5])
def test_topk_pooled_matches_jax_with_ties(start):
    rng = np.random.default_rng(9)
    score = rng.standard_normal((3, 203)).astype(np.float32)
    score[1] = 0.0                       # all tied: lower index first
    score[2, 40:120] = 0.0               # gated silence: tied zeros
    score[2, 7] = score[2, 150] = 5.0    # tied peaks in separate pools
    d_j, s_j = (np.asarray(x) for x in jsync.topk_pooled(
        jnp.asarray(score), start, 16, 8))
    d_t, s_t = (x.numpy() for x in sync.topk_pooled(
        torch.as_tensor(score), start, 16, 8))
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(s_t, s_j)
    assert list(d_t[1, :3]) == [start, start + 8, start + 16]


@pytest.fixture(scope="module")
def cfg0():
    g = build_geometry(0)
    return g, JaxRx(g), RxChain(port_geometry(0), device="cpu")


def _buffer(g, esn0: float, seed: int, decoy_rows=()):
    """The TX frame at the bench.py delay plus numpy noise. In decoy_rows the
    frame starts near the buffer's head instead and a second, 1.5x stronger
    frame follows it whose data symbols alternate between two payloads: it
    wins the acquisition (its preamble and pilots are whole) but fails its
    CRC, so only the rescue decode finds the real frame."""
    rng = np.random.default_rng(seed)
    payload, p1, p2 = (rng.integers(0, 256, (B, g.frame_bytes)).astype(
        np.uint8) for _ in range(3))
    tx = TxChain(port_geometry(g.spec.config), device="cpu")
    frame, f1, f2 = (tx.transmit(torch.as_tensor(p)).numpy()
                     for p in (payload, p1, p2))
    n_fr = frame.shape[1]
    sym = g.nofdm * g.interp
    for j in range(g.preamble_nsymb + 1, g.preamble_nsymb + g.nsymb, 2):
        f1[:, j * sym: (j + 1) * sym] = f2[:, j * sym: (j + 1) * sym]
    n = g.nofdm * g.buffer_nsymb * g.interp
    delay = np.full(B, ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp)
    delay[list(decoy_rows)] = 1000
    buf = rng.standard_normal((B, n)) * sim.sigma_for_esn0(esn0)
    for r in range(B):
        buf[r, delay[r]: delay[r] + n_fr] += frame[r]
        if r in decoy_rows:
            d2 = delay[r] + n_fr + 2000
            buf[r, d2: d2 + n_fr] += 1.5 * f1[r]
    return buf.astype(np.float32), payload, delay


def _assert_same(res, res_j):
    ok = res.crc_ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(res_j.crc_ok))
    np.testing.assert_array_equal(res.delay.numpy(), np.asarray(res_j.delay))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(res_j.iters))
    np.testing.assert_array_equal(res.payload.numpy()[ok],
                                  np.asarray(res_j.payload)[ok])
    np.testing.assert_allclose(res.freq_offset.numpy(),
                               np.asarray(res_j.freq_offset), atol=0.5)
    np.testing.assert_allclose(res.snr_db.numpy(), np.asarray(res_j.snr_db),
                               atol=0.1)


@pytest.mark.parametrize("esn0,seed,decoy_rows,rescue", [
    (12.0, 0, (), False),
    (-5.0, 1, (), True),          # row 2 fails at the right start
    (12.0, 1, (0, 2), True),      # rows 0 and 2 are rescued from a decoy
])
def test_receive_matches_jax(cfg0, esn0, seed, decoy_rows, rescue):
    g, jax_rx, rx = cfg0
    buf, payload, delay = _buffer(g, esn0, seed, decoy_rows)
    pb = torch.as_tensor(buf)
    # the primary candidate and its decode, as receive computes them
    with torch.no_grad():
        d1, cfo1, metric, _ = rx._acquire(pb)
        first = rx._decode_from(pb, d1, cfo1, metric)
    d1_j, cfo1_j, _ = jax_rx._receive_jit(jnp.asarray(buf), stage="refine")
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d1_j))
    np.testing.assert_allclose(cfo1.numpy(), np.asarray(cfo1_j), atol=1e-3)
    assert bool(first.crc_ok.all()) != rescue      # the rescue decode ran
    res = rx.receive(pb)
    _assert_same(res, jax_rx.receive(jnp.asarray(buf)))
    ok = res.crc_ok.numpy()
    assert ok.sum() >= B - 1
    assert (res.payload.numpy()[ok] == payload[ok]).all()
    assert (np.abs(res.delay.numpy() - delay)[ok] <= g.ngi * g.interp).all()
    rescued = ok & ~first.crc_ok.numpy()
    assert list(np.nonzero(rescued)[0]) == list(decoy_rows)


def test_state_carried_across_from_jax(cfg0):
    """A JAX CONFIG_0 chain's host constants, the pilot-only templates
    included, equal the port's own buffers, load into a port chain and give
    the same receive results."""
    g, jax_rx, rx = cfg0
    state = rx_state_from_numpy(
        {name: np.asarray(getattr(jax_rx, name)) for name in RX_BUFFERS
         if hasattr(jax_rx, name)}, device="cpu")
    own = rx.state_dict()
    assert "_pil_templates" in state and set(own) == set(state)
    for name, t in state.items():
        assert t.dtype == own[name].dtype and torch.equal(t, own[name]), name
    fresh = RxChain(rx.geom, device="cpu")
    for t in fresh.state_dict().values():
        t.zero_()
    fresh.load_state_dict(state)
    buf, _payload, _delay = _buffer(g, 12.0, 2)
    a, b = rx.receive(torch.as_tensor(buf)), fresh.receive(torch.as_tensor(buf))
    for field in ("payload", "crc_ok", "delay", "freq_offset", "snr_db",
                  "iters"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_decodes_reference_buffer(golden, cfg0):
    _g, _j, rx = cfg0
    res = rx.receive(torch.as_tensor(golden("cfg0_rx_buffer")[None]))
    assert bool(res.crc_ok[0])
    assert (res.payload[0].numpy()
            == golden("cfg0_rx_bytes").astype(np.uint8)).all()
    assert res.snr_db[0].item() >= golden("cfg0_rx_snr")[0] - 0.75
