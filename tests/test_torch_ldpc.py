"""mercury_tpu_torch.fec.ldpc: encode bit-exact against the reference's
golden codewords; the decoders against the JAX package's: layered
(decode_mm), flooding (decode) and gradient bit-flipping (decode_gbf).

The min-sum and bit-flipping decoders have no transcendental: their bits,
iters and ok are held exact on every row, converged or not. For SPA:

Decoder parity at one noise level where every row converges and one where
some rows do not: `ok` exact, `bits` exact on every converged row, `iters`
within +-1 sweep. tanh/atanh differ in the last ulp between XLA and
PyTorch; where that flips one of the bfloat16 roundings the decoder
mirrors, a row near its convergence boundary finishes one sweep apart (seen
here: 18 against 19 at rate 8). A row that never converges ends in the
chaotic state of a 50-sweep non-converging iteration, so those rows are
held to ok == False and iters == max_iter + 1 only (ROADMAP.md §3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.fec import ldpc as jldpc
from mercury_tpu.fec.tables import load_code
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.modem.rx import RxChain


@pytest.mark.parametrize("cfg,rate", [(0, 1), (3, 4), (9, 8)])
def test_encode_bit_exact(golden, cfg, rate):
    code = load_code(rate)
    gen = torch.as_tensor(code.gen.astype(np.float32))
    bits_in = torch.as_tensor(golden(f"cfg{cfg}_ldpc_in"))[None]
    enc = ldpc.encode(gen, bits_in)[0].numpy()
    assert (enc == golden(f"cfg{cfg}_ldpc_enc")).all()


@pytest.mark.parametrize("rate,n_layers", [(1, None), (4, None),
                                            (8, None), (14, None), (8, 1),
                                            (14, 5)])
def test_layer_plan_matches_reference(rate, n_layers):
    np.testing.assert_array_equal(ldpc.layer_plan(rate, n_layers),
                                  jldpc._layer_plan(rate, n_layers).c_idx)


def _noisy(rate, sigma, seed, rows=8):
    code = load_code(rate)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (rows, code.k))
    cw = np.asarray(jldpc.encode(code, jnp.asarray(u)))
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    return cw, (2 / sigma ** 2 * y).astype(np.float32)


# (rate, sigma) where some rows converge and some do not (min-sum); where
# the SPA rows converge within a few dozen sweeps, so iters stay within 1
MIXED = [(4, 1.3), (8, 0.9), (14, 0.5)]
SPA = [(8, 0.9), (14, 0.48)]


def _assert_exact(got, want, cw):
    bits, iters, ok = (a.numpy() for a in got)
    bits_j, iters_j, ok_j = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(iters, iters_j)
    np.testing.assert_array_equal(bits, bits_j)
    assert (bits[ok] == cw[ok]).all()
    return ok


@pytest.mark.parametrize("n_layers", [None, 1])
@pytest.mark.parametrize("rate,sigma", MIXED)
def test_layered_minsum_exact(rate, sigma, n_layers):
    cw, llr = _noisy(rate, sigma, rate)
    got = ldpc.LayeredDecoder(rate, algo="minsum", n_layers=n_layers)(
        torch.as_tensor(llr))
    want = jldpc.decode_mm(jnp.asarray(llr), rate, algo="minsum",
                           n_layers=n_layers)
    ok = _assert_exact(got, want, cw)
    assert ok.any() and not ok.all()


@pytest.mark.parametrize("msg_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("rate,sigma", MIXED)
def test_flooding_minsum_exact(rate, sigma, msg_dtype):
    cw, llr = _noisy(rate, sigma, rate)
    got = ldpc.FloodingDecoder(
        rate, algo="minsum",
        msg_dtype=getattr(torch, msg_dtype) if msg_dtype else None)(
            torch.as_tensor(llr))
    want = jldpc.decode(jnp.asarray(llr), rate, algo="minsum",
                        msg_dtype=getattr(jnp, msg_dtype) if msg_dtype
                        else None)
    ok = _assert_exact(got, want, cw)
    assert ok.any()


@pytest.mark.parametrize("rate,sigma", [(4, 0.45), (14, 0.45)])
def test_gbf_exact(rate, sigma):
    """decode_gbf counts iterations from 1; at these noise levels some rows
    converge and some do not."""
    cw, llr = _noisy(rate, sigma, rate + 1)
    got = ldpc.decode_gbf(torch.as_tensor(llr), rate)
    want = jldpc.decode_gbf(jnp.asarray(llr), rate)
    ok = _assert_exact(got, want, cw)
    assert ok.any() and not ok.all()
    assert (got[1].numpy()[ok] >= 1).all()


@pytest.mark.parametrize("rate,sigma", SPA)
def test_flooding_spa_matches_decode(rate, sigma):
    cw, llr = _noisy(rate, sigma, rate)
    bits, iters, ok = (a.numpy() for a in ldpc.FloodingDecoder(rate)(
        torch.as_tensor(llr)))
    bits_j, iters_j, ok_j = (np.asarray(a) for a in
                             jldpc.decode(jnp.asarray(llr), rate))
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(bits[ok], bits_j[ok])
    assert np.abs(iters - iters_j)[ok].max() <= 1
    assert (iters[~ok] == 51).all() and (bits[ok] == cw[ok]).all()


@pytest.mark.parametrize("rate,sigma", SPA)
def test_soft_layered_posterior(rate, sigma):
    """soft=True returns decode_mm's posterior. On rows that converged at
    the same sweep it is equal in sign everywhere and within rtol 0.3 /
    atol 1: a last-ulp tanh/atanh difference that flips one bfloat16
    rounding of the posterior moves its later magnitudes by up to ~25%
    (seen: 2.7 on an LLR of 35), not its decisions."""
    cw, llr = _noisy(rate, sigma, rate)
    bits, iters, ok, post = (a.numpy() for a in ldpc.LayeredDecoder(rate)(
        torch.as_tensor(llr), soft=True))
    bits_j, iters_j, ok_j, post_j = (np.asarray(a) for a in jldpc.decode_mm(
        jnp.asarray(llr), rate, soft=True))
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(bits[ok], bits_j[ok])
    assert np.abs(iters - iters_j)[ok].max() <= 1
    same = ok & (iters == iters_j)
    assert same.any()
    np.testing.assert_array_equal(np.sign(post[same]), np.sign(post_j[same]))
    np.testing.assert_allclose(post[same], post_j[same], rtol=0.3, atol=1.0)
    np.testing.assert_array_equal(bits, (post < 0).astype(bits.dtype))


@pytest.mark.parametrize("rate,sigma,mixed", [
    (1, 2.0, False), (1, 2.5, True), (4, 1.0, False), (4, 1.35, True), (8, 0.8, False), (8, 0.85, True)])
def test_layered_decode_matches_decode_mm(rate, sigma, mixed):
    code = load_code(rate)
    rng = np.random.default_rng(rate * 100 + int(sigma * 100))
    u = rng.integers(0, 2, (8, code.k))
    cw = np.asarray(jldpc.encode(code, jnp.asarray(u)))
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2 / sigma ** 2 * y).astype(np.float32)
    bits_j, iters_j, ok_j = (np.asarray(a) for a in
                             jldpc.decode_mm(jnp.asarray(llr), rate))
    bits, iters, ok = (a.numpy() for a in
                       ldpc.LayeredDecoder(rate)(torch.as_tensor(llr)))
    np.testing.assert_array_equal(ok, ok_j)
    assert np.abs(iters - iters_j).max() <= 1
    np.testing.assert_array_equal(bits[ok], bits_j[ok_j])
    assert (bits[ok] == cw[ok]).all()
    assert ok.all() != mixed and ok.any()
    assert (iters[~ok] == 51).all()


def test_clean_input_reports_zero_iterations():
    code = load_code(4)
    u = np.random.default_rng(1).integers(0, 2, (3, code.k))
    cw = np.asarray(jldpc.encode(code, jnp.asarray(u)))
    llr = torch.as_tensor((4.0 * (1 - 2 * cw)).astype(np.float32))
    bits, iters, ok = ldpc.LayeredDecoder(4)(llr)
    assert ok.all() and (iters == 0).all()
    assert (bits.numpy() == cw).all()


def test_set_ldpc_max_iter_caps_the_receive_decoder():
    """RxChain.set_ldpc_max_iter reaches the decoder the receive runs: a
    5-sweep cap gives decode_mm(max_iter=5)'s ok, and max_iter+1 = 6 on
    the rows it leaves."""
    rx = RxChain(port_geometry(9), device="cpu")
    rx.set_ldpc_max_iter(5)
    _cw, llr = _noisy(8, 0.8, 3)
    _bits, iters, ok = (a.numpy() for a in rx.decoder(torch.as_tensor(llr)))
    _bj, iters_j, ok_j = (np.asarray(a) for a in jldpc.decode_mm(
        jnp.asarray(llr), 8, max_iter=5))
    np.testing.assert_array_equal(ok, ok_j)
    assert (iters[~ok] == 6).all() and (iters[ok] <= 5).all()
    assert ok.any() and not ok.all()
