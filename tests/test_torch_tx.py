"""mercury_tpu_torch.modem.tx: float64 passband against the reference's
golden frames (5e-10, the standard of tests/test_tx.py) for CONFIG_3, 9,
10-16 and the MFSK modes 100-102 at both pilot densities, float32 against
the JAX TxChain (atol 1e-5), MFSK control frames included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.core.modes import LOW_DENSITY
from mercury_tpu.modem.tx import TxChain as JaxTx
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.tx import TxChain


# the top of the ladder: 8PSK (10, 11, 14), 16QAM (13, 15), 32QAM cross (16)
TOP = [10, 11, 12, 13, 14, 15, 16]
# the MFSK ROBUST modes: 32-MFSK (100), 16-MFSK in two streams (101, 102)
MFSK = [100, 101, 102]


@pytest.mark.parametrize("cfg", [3, 9] + TOP + MFSK)
def test_float64_passband_matches_golden(golden, cfg):
    check_golden(golden, cfg, f"cfg{cfg}", port_geometry(cfg))


@pytest.mark.parametrize("cfg", TOP + MFSK)
def test_float64_passband_matches_golden_low_density(golden, cfg):
    check_golden(golden, cfg, f"cfg{cfg}ld", port_geometry(cfg, LOW_DENSITY))


def check_golden(golden, cfg, tag, geom):
    tx = TxChain(geom, dtype=torch.float64, device="cpu")
    payload = torch.as_tensor(
        golden(f"{tag}_payload_bytes").astype(np.uint8))[None]
    nofilter = tx.transmit(payload, filtered=False)[0].numpy()
    single = tx.transmit(payload)[0].numpy()
    np.testing.assert_allclose(nofilter, golden(f"{tag}_tx_passband_nofilter"),
                               atol=5e-10)
    np.testing.assert_allclose(single, golden(f"{tag}_tx_passband_single"),
                               atol=5e-10)


@pytest.mark.parametrize("cfg", [3, 9, 11, 13, 16])
def test_float32_matches_jax_txchain(cfg):
    g = build_geometry(cfg)
    rng = np.random.default_rng(cfg)
    payload = rng.integers(0, 256, (3, g.frame_bytes)).astype(np.uint8)
    payload[2, 10:] = 0
    want = np.asarray(JaxTx(g).transmit(jnp.asarray(payload[:, :])))
    tx = TxChain(port_geometry(cfg), device="cpu")
    got = tx.transmit(torch.as_tensor(payload))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # a short payload is zero-padded to the frame
    short = tx.transmit(torch.as_tensor(payload[2:, :10]))
    np.testing.assert_allclose(short.numpy(), want[2:], atol=1e-5)


@pytest.mark.parametrize("cfg,ctrl", [(100, False), (101, False),
                                      (102, False), (100, True), (101, True)])
def test_float32_mfsk_matches_jax_txchain(cfg, ctrl):
    """A control frame is Nofdm*(preamble + ctrl_nsymb)*interp samples
    (tests/test_mfsk_ctrl.py:22), shorter than a data frame."""
    g = build_geometry(cfg)
    payload = np.random.default_rng(cfg).integers(
        0, 256, (2, g.frame_bytes)).astype(np.uint8)
    want = np.asarray(JaxTx(g, ctrl=ctrl).transmit(jnp.asarray(payload)))
    tx = TxChain(port_geometry(cfg), device="cpu", ctrl=ctrl)
    got = tx.transmit(torch.as_tensor(payload))
    nsymb = g.ctrl_nsymb if ctrl else g.nsymb
    assert got.shape == want.shape == (
        2, g.nofdm * (g.preamble_nsymb + nsymb) * g.interp)
    assert (got.shape[1] < g.total_frame_size) == ctrl
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_ctrl_outside_robust_raises():
    """Control frames exist on ROBUST_0/1 only: ValueError on an OFDM mode,
    as the JAX TxChain raises (tests/test_mfsk_ctrl.py:33)."""
    with pytest.raises(ValueError):
        JaxTx(build_geometry(9), ctrl=True)
    with pytest.raises(ValueError, match="ROBUST_0/ROBUST_1"):
        TxChain(port_geometry(9), device="cpu", ctrl=True)


def test_transmit_batch_matches_jax_and_decodes():
    """transmit_batch (TX FIRs over the concatenated stream, one frame copy
    of padding at each end) equals the JAX chain's to 1e-5, and each frame,
    windowed alone, decodes (tests/test_stream.py:40's bar, CONFIG_6);
    rows that are not full width raise ValueError."""
    from mercury_tpu_torch.modem.rx import RxChain

    g = build_geometry(6)
    payload = np.stack([np.full(g.frame_bytes, 7 * (i + 1), np.uint8)
                        for i in range(3)])
    want = np.asarray(JaxTx(g).transmit_batch(jnp.asarray(payload)))
    tx = TxChain(port_geometry(6), device="cpu")
    got = tx.transmit_batch(torch.as_tensor(payload))
    assert got.shape == want.shape == (3, g.total_frame_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # interior frames see real neighbours: not the single-frame filtering
    single = tx.transmit(torch.as_tensor(payload))
    assert not torch.equal(got[1], single[1])
    rx = RxChain(port_geometry(6), device="cpu")
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    win = torch.zeros((3, buf_len))
    win[:, : g.total_frame_size] = got
    res = rx.receive(win)
    assert res.crc_ok.all()
    assert (res.payload.numpy() == payload).all()
    with pytest.raises(ValueError):
        tx.transmit_batch(torch.zeros((2, 3), dtype=torch.uint8))
