"""The last receive options of mercury_tpu_torch against the JAX package, on
the same numpy buffers: RxChain.receive's sync_limit (CONFIG_16, CONFIG_0,
CONFIG_100) and stage ("sync", "refine", "hyp" at CONFIG_16, "arb" at
CONFIG_0), deep_profile "c2f" and "full" (CONFIG_3), real_dtype float64
on the CPU (CONFIG_9), sync.coherent_preamble_rescore on CONFIG_0's bank
and the legacy guard-interval metrics on tests/test_legacy_sync.py's inputs.

Each buffer holds two frames of batch 2: A, and after it B at twice A's
amplitude, whose start the sync_limit cuts, so that the limit changes
which frame decodes. Tolerances: crc_ok, delays, candidate starts and
decoded payloads equal; iters within one sweep (test_torch_ldpc.py);
freq_offset within 0.5 Hz and snr_db within 0.1 dB (test_torch_rx.py);
Schmidl-Cox metrics rtol 1e-4 / atol 1e-5 and their CFOs atol 1e-3 Hz
(test_torch_sync.py); equalized grids and variances atol / rtol 1e-4
(test_torch_rx.py's grid_stats); arbitration scores rtol 2e-4 / atol 2e-4
(test_torch_coherent.py's matched-filter bar); the rescore rtol 1e-5; the
legacy metrics rtol 1e-4 / atol 1e-5 (float32 prefix sums in another
order, test_torch_sync.py's Schmidl-Cox bar)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem import sync as jsync
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem import sync
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

B = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_CHAINS = {}


def _chains(cfg: int, **kw):
    """(JAX geometry, JAX chain, port chain) of a config, built once."""
    key = (cfg, tuple(sorted(kw.items())))
    if key not in _CHAINS:
        g = build_geometry(cfg)
        jkw = {k: (jnp.float64 if v is torch.float64 else v)
               for k, v in kw.items()}
        _CHAINS[key] = (g, JaxRx(g, **jkw),
                        RxChain(port_geometry(cfg),
                                device="cpu", **kw))
    return _CHAINS[key]


def _two_frames(g, snr: float, seed: int):
    """Batch-2 standard buffers of frame A (row r at a lead of half a
    symbol plus 37 r samples; an MFSK frame at 0) and frame B at twice A's
    amplitude 2 symbols after A's end (an MFSK frame right after it), in
    white noise at Es/N0 snr (an MFSK mode: A's channel SNR).
    -> (buffer, A's payloads, B's payloads, A's starts, B's starts, a
    sync_limit that cuts B's start and not A's)."""
    rng = np.random.default_rng(seed)
    pa, pb = (rng.integers(0, 256, (B, g.frame_bytes)).astype(np.uint8)
              for _ in range(2))
    tx = TxChain(port_geometry(g.spec.config), device="cpu")
    fa, fb = (tx.transmit(torch.as_tensor(p)).numpy() for p in (pa, pb))
    sym = g.nofdm * g.interp
    n_fr = fa.shape[1]
    n = g.nofdm * g.buffer_nsymb * g.interp
    if g.spec.is_mfsk:
        da = np.zeros(B, np.int64)
        db = da + n_fr
        sigma = sim.sigma_for_channel_snr(torch.as_tensor(fa[0]), snr, g.fs,
                                          g.bandwidth)
    else:
        da = np.array([sym // 2 + 37 * r for r in range(B)])
        db = da + n_fr + 2 * sym
        sigma = sim.sigma_for_esn0(snr)
    buf = rng.standard_normal((B, n)) * sigma
    for r in range(B):
        buf[r, da[r]: da[r] + n_fr] += fa[r]
        buf[r, db[r]: db[r] + n_fr] += 2.0 * fb[r]
    limit = int(db.min()) if g.spec.is_mfsk else int(da.max() + n_fr + sym)
    return buf.astype(np.float32), pa, pb, da, db, limit


def _assert_same(res, res_j):
    ok = res.crc_ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(res_j.crc_ok))
    np.testing.assert_array_equal(res.delay.numpy(), np.asarray(res_j.delay))
    assert np.abs(res.iters.numpy() - np.asarray(res_j.iters)).max() <= 1
    np.testing.assert_array_equal(res.payload.numpy()[ok],
                                  np.asarray(res_j.payload)[ok])
    np.testing.assert_allclose(res.freq_offset.numpy(),
                               np.asarray(res_j.freq_offset), atol=0.5)
    np.testing.assert_allclose(res.snr_db.numpy(), np.asarray(res_j.snr_db),
                               atol=0.1)


@pytest.mark.parametrize("cfg,snr", [(16, 31.0), (0, 6.0), (100, -3.0)])
def test_sync_limit_matches_jax(cfg, snr):
    """Without the limit B (stronger) is decoded, with it A, as the JAX
    chain decodes it (the unlimited receive's parity is test_torch_rx.py's
    and test_torch_mfsk.py's)."""
    g, jax_rx, rx = _chains(cfg)
    buf, pa, pb, da, db, limit = _two_frames(g, snr, cfg)
    x = torch.as_tensor(buf)
    for lim, payload, start in ((None, pb, db), (limit, pa, da)):
        res = rx.receive(x, sync_limit=lim)
        assert res.crc_ok.all(), (lim, res.crc_ok)
        assert (res.payload.numpy() == payload).all()
        assert (np.abs(res.delay.numpy() - start) <= g.ngi * g.interp).all()
    assert (res.delay.numpy() < limit).all()
    _assert_same(res, jax_rx._receive_jit(jnp.asarray(buf),
                                          sync_limit=limit))


def test_stages_match_jax_config16():
    g, jax_rx, rx = _chains(16)
    buf, _pa, _pb, _da, _db, limit = _two_frames(g, 31.0, 7)
    x, xj = torch.as_tensor(buf), jnp.asarray(buf)
    cands, cfos, metric = rx.receive(x, stage="sync", sync_limit=limit)
    cands_j, cfos_j, metric_j = jax_rx._receive_jit(xj, stage="sync",
                                                    sync_limit=limit)
    assert len(cands) == len(cands_j) == 3
    for c, c_j, f, f_j in zip(cands, cands_j, cfos, cfos_j):
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
        assert (c.numpy() < limit).all()
        np.testing.assert_allclose(f.numpy(), np.asarray(f_j), atol=1e-3)
    np.testing.assert_allclose(metric.numpy(), np.asarray(metric_j),
                               rtol=1e-4, atol=1e-5)
    delay, cfo, metric = rx.receive(x, stage="refine")
    delay_j, cfo_j, metric_j = jax_rx._receive_jit(xj, stage="refine")
    np.testing.assert_array_equal(delay.numpy(), np.asarray(delay_j))
    np.testing.assert_allclose(cfo.numpy(), np.asarray(cfo_j), atol=1e-3)
    np.testing.assert_allclose(metric.numpy(), np.asarray(metric_j),
                               rtol=1e-4, atol=1e-5)
    for got, want in zip(rx.receive(x, stage="hyp"),
                         jax_rx._receive_jit(xj, stage="hyp")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_arbitration_stage_matches_jax_config0():
    """CONFIG_0's coherent nominees (delay, scan score, CFO) [M, B] under
    a limit that cuts B's start."""
    g, jax_rx, rx = _chains(0)
    buf, _pa, _pb, _da, _db, limit = _two_frames(g, 6.0, 3)
    got = rx.receive(torch.as_tensor(buf), stage="arb", sync_limit=limit)
    want = jax_rx._receive_jit(jnp.asarray(buf), stage="arb",
                               sync_limit=limit)
    assert got[0].shape == (32, B)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[0].numpy()[np.isfinite(got[1].numpy())] < limit).all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("profile", ["c2f", "full"])
def test_deep_profiles_match_jax_config3(profile):
    """The arbitration stacks (c2f: 7 candidates x 5 bank offsets; full:
    3 candidates x 3 aliases and a 17-row 15 Hz scan), from which the
    receive picks, and A decoded under the limit."""
    g, jax_rx, rx = _chains(3, deep_profile=profile)
    buf, pa, _pb, da, _db, limit = _two_frames(g, 10.0, 30)
    x, xj = torch.as_tensor(buf), jnp.asarray(buf)
    delays, scores, cfos = rx.receive(x, stage="arb", sync_limit=limit)
    want = jax_rx._receive_jit(xj, stage="arb", sync_limit=limit)
    assert delays.shape == ((7 * 5, B) if profile == "c2f" else (9 + 17, B))
    np.testing.assert_array_equal(delays.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(cfos.numpy(), np.asarray(want[2]), atol=1e-3)
    res = rx.receive(x, sync_limit=limit)
    assert res.crc_ok.all() and (res.payload.numpy() == pa).all()


def test_float64_chain_matches_jax_float64():
    g, jax_rx, rx = _chains(9, real_dtype=torch.float64)
    buf, pa, _pb, da, _db, limit = _two_frames(g, 12.0, 9)
    res = rx.receive(torch.as_tensor(buf), sync_limit=limit)
    res_j = jax_rx._receive_jit(jnp.asarray(buf), sync_limit=limit)
    assert res.freq_offset.dtype == torch.float64
    assert np.asarray(res_j.freq_offset).dtype == np.float64
    _assert_same(res, res_j)
    assert res.crc_ok.all() and (res.payload.numpy() == pa).all()


def test_coherent_preamble_rescore_matches_jax():
    g, _jax_rx, rx = _chains(0)
    buf, _pa, _pb, da, _db, _limit = _two_frames(g, 6.0, 4)
    mf_d, ts_dec = 2 * g.interp, g.interp
    grid, bank, _pil, _prep = rx._coherent_banks(mf_d)
    lp = g.preamble_nsymb
    bank = bank.reshape(len(grid), lp, -1)             # [F, Lp, S_d]
    bb_ts = rx.to_baseband(torch.as_tensor(buf), data_fir=False)[:, ::ts_dec]
    cands = np.stack([da - da % mf_d + k * mf_d for k in (-3, 0, 2, 40)],
                     axis=1)
    got = sync.coherent_preamble_rescore(bb_ts, torch.as_tensor(cands),
                                         bank, 2, ts_dec)
    want = jsync.coherent_preamble_rescore(jnp.asarray(bb_ts.numpy()),
                                           jnp.asarray(cands),
                                           bank.numpy(), 2, ts_dec)
    assert got.shape == (B, 4, len(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    # the true start's best CFO row is the grid's 0 Hz
    assert (got[:, 1].argmax(-1).numpy() == len(grid) // 2).all()


def _legacy_inputs():
    """tests/test_legacy_sync.py's cyclic-prefixed symbols at delay 37 and
    its 5-symbol frame."""
    g = build_geometry(0, with_pre_eq=False)
    rng = np.random.default_rng(0)
    nsym = 6
    td = (rng.standard_normal((nsym, g.nfft))
          + 1j * rng.standard_normal((nsym, g.nfft)))
    sym = np.concatenate([td[:, -g.ngi:], td], axis=1).reshape(-1)
    x = 0.01 * (rng.standard_normal(37 + len(sym) + 200)
                + 1j * rng.standard_normal(37 + len(sym) + 200))
    x[37: 37 + len(sym)] += sym
    rng = np.random.default_rng(1)
    frame = (rng.standard_normal(5 * g.nofdm)
             + 1j * rng.standard_normal(5 * g.nofdm))
    return g, x.astype(np.complex64)[None], frame.astype(np.complex64)[None]


def test_legacy_gi_metrics_match_jax():
    g, x, frame = _legacy_inputs()
    pg = port_geometry(0, with_pre_eq=False)
    got = sync.gi_time_sync_metric(torch.as_tensor(x), pg, decim=g.interp,
                                   ts_nsymb=4)
    want = jsync.gi_time_sync_metric(jnp.asarray(x), g, decim=g.interp,
                                     ts_nsymb=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    got_s = sync.gi_symbol_sync_metric(torch.as_tensor(frame), pg)
    want_s = jsync.gi_symbol_sync_metric(jnp.asarray(frame), g)
    assert got_s.shape == (1, 5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-5)
