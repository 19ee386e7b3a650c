"""The ported receive slice as a whole: mercury_tpu_torch RxChain.receive
against mercury_tpu RxChain.receive on the same capture buffers (the TX
frame at the bench.py delay plus one shared numpy noise array), at
CONFIG_3 (BPSK 4/16 with automatic deep sync) and CONFIG_9 (QPSK 8/16).

Equal: crc_ok, delay, iters, and the payload of every row that decodes.
A row that fails to decode ends in the chaotic state of a non-converging
50-sweep LDPC iteration; its garbage payload depends on last-ulp
differences between XLA's and PyTorch's tanh/atanh and is not compared
(test_torch_ldpc.py). freq_offset within 0.5 Hz, snr_db within 0.1 dB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.convert import RX_BUFFERS, rx_state_from_numpy
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

B = 4


@pytest.fixture(scope="module")
def chains():
    cache = {}

    def get(cfg):
        if cfg not in cache:
            g = build_geometry(cfg)
            cache[cfg] = (g, JaxRx(g),
                          RxChain(port_geometry(cfg), device="cpu"))
        return cache[cfg]

    return get


def _buffer(g, esn0: float, seed: int):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (B, g.frame_bytes)).astype(np.uint8)
    tx = TxChain(port_geometry(g.spec.config), device="cpu")
    frames = tx.transmit(torch.as_tensor(payload)).numpy()
    n = g.nofdm * g.buffer_nsymb * g.interp
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = rng.standard_normal((B, n)) * sim.sigma_for_esn0(esn0)
    buf[:, delay: delay + frames.shape[1]] += frames
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


@pytest.mark.parametrize("cfg,esn0,all_ok", [
    (3, 12.0, True), (9, 12.0, True),
    (3, -0.5, False),            # near CONFIG_3's threshold: some rows fail
])
def test_receive_matches_jax(chains, cfg, esn0, all_ok):
    g, jax_rx, rx = chains(cfg)
    buf, payload, delay = _buffer(g, esn0, seed=cfg)
    res = rx.receive(torch.as_tensor(buf))
    res_j = jax_rx.receive(jnp.asarray(buf))
    _assert_same(res, res_j)
    ok = res.crc_ok.numpy()
    assert ok.all() == all_ok and ok.any()
    assert (res.payload.numpy()[ok] == payload[ok]).all()
    assert (np.abs(res.delay.numpy() - delay) <= g.ngi * g.interp).all()


@pytest.mark.parametrize("cfg", [3, 9])
def test_decodes_reference_buffer(golden, chains, cfg):
    _g, _j, rx = chains(cfg)
    res = rx.receive(torch.as_tensor(golden(f"cfg{cfg}_rx_buffer")[None]))
    assert bool(res.crc_ok[0])
    assert (res.payload[0].numpy()
            == golden(f"cfg{cfg}_rx_bytes").astype(np.uint8)).all()
    assert res.snr_db[0].item() >= golden(f"cfg{cfg}_rx_snr")[0] - 0.75


def test_state_carried_across_from_jax(chains):
    """The JAX chain's host constants, converted, equal the port's own
    buffers, load into a port chain and give the same receive results."""
    g, jax_rx, rx = chains(9)
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
    buf, _payload, _delay = _buffer(g, 12.0, seed=1)
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


@pytest.mark.parametrize("cfg,geom_kw,kwargs,item", [
    (0, {}, {"deep_profile": "full"}, "item 8"),   # round-3 deep scan
    (3, {}, {"deep_profile": "c2f"}, "item 8"),
    (10, {}, {}, "item 9"),                   # dd auto for 8PSK
    (13, {}, {"dd": False}, "item 9"),        # QAM MER SNR
    (15, {"estimator": "reference"}, {}, "item 10"),   # zero-forcing
    (9, {}, {"bicm_iters": 1}, "item 10"),
    (9, {}, {"ldpc_algo": "spa"}, "item 10"),  # flooding decoder
    (100, {}, {}, "item 11"),                 # MFSK
])
def test_out_of_slice_options_raise(cfg, geom_kw, kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1, {item}"):
        RxChain(port_geometry(cfg, **geom_kw), device="cpu", **kwargs)
