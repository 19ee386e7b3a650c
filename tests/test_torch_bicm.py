"""BICM-ID (iterative demapping and decoding) of mercury_tpu_torch's RxChain
against the JAX RxChain, on CONFIG_16 (32QAM 14/16, whose cross mapping is
not Gray and where the JAX chain turns BICM-ID on by default), with the
numpy carrier grids of test_torch_dd.py fed to both.

The JAX package has no BICM-ID test of its own; these hold both packages to
recovering rows the first decode lost. At 15.0 dB (this harness: complex
AWGN of variance 10^(-EsN0/10) per cell, the Es/N0 of docs/bicm_id_r5.md's
CONFIG_16 rows) some first decodes fail and BICM-ID recovers them. Rows that
never converge carry the XLA/PyTorch last-ulp differences into each
re-decode (test_torch_dd.py), so the rows compared are those that decode;
the inputs are fixed and the two packages agree on them here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dd import bb_grid, one_thread, random_bits  # noqa: F401
from test_torch_rx import _assert_same, _buffer

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.rx import RxChain

ESN0 = 15.0


@pytest.fixture(scope="module")
def case():
    g = port_geometry(16)
    bits = random_bits(g, 0)
    return g, bits, bb_grid(g, bits, ESN0, 0)


def _chains(**kw):
    return (JaxRx(build_geometry(16), **kw),
            RxChain(port_geometry(16), device="cpu", **kw))


def _row_errors(got, bits):
    return (np.asarray(got) != bits).any(-1)


@pytest.mark.parametrize("kw", [
    {},                                   # the defaults: BICM-ID 2 and DD
    {"dd": False},                        # BICM-ID alone
])
def test_bb_decode_bits_recovers_rows(case, kw):
    """The same rows decode in both packages, at least one of them a row
    the first decode lost, and no row that decoded at first is lost."""
    g, bits, grid = case
    jax_rx, rx = _chains(**kw)
    assert rx.bicm_iters == jax_rx.bicm_iters == 2
    got = rx.bb_decode_bits(torch.as_tensor(grid)).numpy()
    want = np.asarray(jax_rx.bb_decode_bits(jnp.asarray(grid)))
    err, err_j = _row_errors(got, bits), _row_errors(want, bits)
    np.testing.assert_array_equal(err, err_j)
    np.testing.assert_array_equal(got[~err], want[~err])
    plain = RxChain(port_geometry(16), device="cpu", dd=False, bicm_iters=0)
    err1 = _row_errors(plain.bb_decode_bits(torch.as_tensor(grid)), bits)
    assert not (err & ~err1).any()
    assert err.sum() < err1.sum()


def test_bicm_decode_matches_jax(case):
    """_bicm_decode on the same LLRs, symbols and variance: converged
    flags equal; bits equal on converged rows; iters within 1 on rows the
    first decode converged (one SPA pass) and summed over the passes
    (above max_iter) on the others."""
    g, _bits, grid = case
    jax_rx, rx = _chains(dd=False)
    llr, (_f, _s, data, var, _m, _v) = rx._ofdm_llr(torch.as_tensor(grid))
    bits, iters, conv = (a.numpy() for a in rx._bicm_decode(llr, data, var))
    bits_j, iters_j, conv_j = (np.asarray(a) for a in jax_rx._bicm_decode(
        jnp.asarray(llr.numpy()), jnp.asarray(data.numpy()),
        jnp.asarray(var.numpy())))
    np.testing.assert_array_equal(conv, conv_j)
    np.testing.assert_array_equal(bits[conv], bits_j[conv])
    first = iters_j <= rx.ldpc_max_iter
    assert np.abs(iters - iters_j)[first].max() <= 1
    assert (iters[~first] > rx.ldpc_max_iter).all()
    # some rows went through BICM-ID and converged there
    assert (conv & ~first).any()


def test_receive_near_threshold_matches_jax():
    """Full receive of a CONFIG_16 buffer at 20 dB (batch 8), where some
    first decodes fail: the same rows decode in both packages, to the
    payloads sent, some of them only through BICM-ID or DD."""
    jax_rx, rx = _chains()
    g = build_geometry(16)
    buf, payload, _delay = _buffer(g, 20.0, seed=16, b=8)
    res = rx.receive(torch.as_tensor(buf))
    _assert_same(res, jax_rx.receive(jnp.asarray(buf)), recovery=True)
    ok = res.crc_ok.numpy()
    assert ok.any() and not ok.all()
    assert (res.payload.numpy()[ok] == payload[ok]).all()
    assert (ok & (res.iters.numpy() > rx.ldpc_max_iter)).any()
