"""mercury_tpu_torch.fec.ldpc: encode bit-exact against the reference's
golden codewords; the layered SPA decoder against the JAX decode_mm.

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
from mercury_tpu_torch.fec import ldpc


@pytest.mark.parametrize("cfg,rate", [(0, 1), (3, 4), (9, 8)])
def test_encode_bit_exact(golden, cfg, rate):
    code = load_code(rate)
    gen = torch.as_tensor(code.gen.astype(np.float32))
    bits_in = torch.as_tensor(golden(f"cfg{cfg}_ldpc_in"))[None]
    enc = ldpc.encode(gen, bits_in)[0].numpy()
    assert (enc == golden(f"cfg{cfg}_ldpc_enc")).all()


@pytest.mark.parametrize("rate", [1, 4, 8])
def test_layer_plan_matches_reference(rate):
    np.testing.assert_array_equal(ldpc.layer_plan(rate),
                                  jldpc._layer_plan(rate, None).c_idx)


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
