"""mercury_tpu_torch.modem.psk against mercury_tpu.modem.psk: mapping
exact, max-log LLRs to rtol 1e-5 (float32), full log-MAP LLRs (with and
without bit priors) to rtol 1e-5 / atol 1e-4 (log-sum-exp in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import psk_constellation
from mercury_tpu.modem import psk as jpsk
from mercury_tpu_torch.modem import psk


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
def test_mod_and_maxlog_demod(m):
    rng = np.random.default_rng(m)
    const = psk_constellation(m).astype(np.complex64)
    nbits = int(np.log2(m))
    bits = rng.integers(0, 2, (3, 40 * nbits))
    sym = psk.mod(torch.as_tensor(bits), torch.as_tensor(const))
    sym_j = jpsk.mod(jnp.asarray(bits), jnp.asarray(const))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(sym_j))
    noisy = (sym.numpy() + 0.3 * (rng.standard_normal(sym.shape)
                                  + 1j * rng.standard_normal(sym.shape))
             ).astype(np.complex64)
    var = np.array([0.2, 0.5, 1.0], np.float32)
    llr = psk.demod(torch.as_tensor(noisy), torch.as_tensor(const),
                    torch.as_tensor(var))
    llr_j = jpsk.demod(jnp.asarray(noisy), jnp.asarray(const), jnp.asarray(var))
    np.testing.assert_allclose(llr.numpy(), np.asarray(llr_j), rtol=1e-5,
                               atol=1e-5)
    # hard decisions of the noiseless symbols give back the bits
    clean = psk.demod(sym, torch.as_tensor(const), torch.ones(3))
    assert ((clean.numpy() < 0) == bits.astype(bool)).all()


@pytest.mark.parametrize("priors", [False, True])
@pytest.mark.parametrize("m", [8, 16, 32])
def test_demod_full_matches_jax(m, priors):
    rng = np.random.default_rng(100 + m)
    const = psk_constellation(m).astype(np.complex64)
    nbits = int(np.log2(m))
    bits = rng.integers(0, 2, (3, 50 * nbits))
    sym = psk.mod(torch.as_tensor(bits), torch.as_tensor(const)).numpy()
    noisy = (sym + 0.25 * (rng.standard_normal(sym.shape)
                           + 1j * rng.standard_normal(sym.shape))
             ).astype(np.complex64)
    var = np.array([0.05, 0.125, 0.3], np.float32)
    la = (rng.standard_normal((3, 50, nbits)) * 3).astype(np.float32) \
        if priors else None
    got = psk.demod_full(torch.as_tensor(noisy), torch.as_tensor(const),
                         torch.as_tensor(var),
                         None if la is None else torch.as_tensor(la))
    want = jpsk.demod_full(jnp.asarray(noisy), jnp.asarray(const),
                           jnp.asarray(var),
                           None if la is None else jnp.asarray(la))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    if not priors:
        # the max-log LLRs approximate the log-MAP ones in sign
        maxlog = psk.demod(torch.as_tensor(noisy), torch.as_tensor(const),
                           torch.as_tensor(var)).numpy()
        agree = np.sign(maxlog) == np.sign(got.numpy())
        assert agree.mean() > 0.95
