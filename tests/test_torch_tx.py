"""mercury_tpu_torch.modem.tx: float64 passband against the reference's
golden frames (5e-10, the standard of tests/test_tx.py), float32 against
the JAX TxChain (atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem.tx import TxChain as JaxTx
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.tx import TxChain


@pytest.mark.parametrize("cfg", [3, 9])
def test_float64_passband_matches_golden(golden, cfg):
    tx = TxChain(port_geometry(cfg), dtype=torch.float64, device="cpu")
    payload = torch.as_tensor(golden(f"cfg{cfg}_payload_bytes").astype(np.uint8))[None]
    nofilter = tx.transmit(payload, filtered=False)[0].numpy()
    single = tx.transmit(payload)[0].numpy()
    np.testing.assert_allclose(nofilter, golden(f"cfg{cfg}_tx_passband_nofilter"),
                               atol=5e-10)
    np.testing.assert_allclose(single, golden(f"cfg{cfg}_tx_passband_single"),
                               atol=5e-10)


@pytest.mark.parametrize("cfg", [3, 9])
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


def test_out_of_port_modes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TxChain(port_geometry(100), device="cpu")
