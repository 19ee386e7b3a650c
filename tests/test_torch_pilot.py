"""The pilot-lattice arbitration of CONFIG_0's deep acquisition in
mercury_tpu_torch against the JAX package: sync.pilot_rescore and the plain
version of the `pilot_cand_score` kernel against sync.pilot_rescore's XLA
path (rtol 1e-5: the same float32 sums in another order), and on stationary
rows against its Pallas kernel in interpret mode (rtol 2e-5, atol 1e-5, the
bar tests/test_pilot_kernel.py holds the kernel to).

The two JAX paths take the silence floor from different energies: the XLA
path from the mean energy of the symbols it scores (sync.py:478), the Pallas
kernel from the whole row (pallas_kernels.py:605-608). The port follows the
XLA path, which is what the JAX receive runs on the CPU; a bursty row, loud
in one half and near-silent in the other, shows the difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.modem import sync as jsync
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.modem import sync

MF_S, TS_DEC, PRE_SPAN = 2, 4, 48


def _bank(rng, f_n=13, nsym=5, s_d=136):
    base = (rng.standard_normal((nsym, s_d))
            + 1j * rng.standard_normal((nsym, s_d))).astype(np.complex64)
    t = np.arange(s_d)
    return np.stack([base * np.exp(-1j * 2 * np.pi * f * 1e-4 * t)[None]
                     for f in range(f_n)]).astype(np.complex64)


def _case(bursty: bool):
    """tests/test_pilot_kernel.py:13-31's inputs (4 rows, 9 candidates, 13
    CFO rows of a 5-symbol template). Candidates 7 and 8 are clipped at the
    start and at the end of the row. With `bursty`, the second half of row 3
    is zero and its candidates straddle the edge of the burst."""
    rng = np.random.default_rng(3)
    b, m, n_ts = 4, 9, 6000
    bb = (rng.standard_normal((b, n_ts))
          + 1j * rng.standard_normal((b, n_ts))).astype(np.complex64)
    step = MF_S * TS_DEC
    cand = (rng.integers(0, 200, (b, m)) * step).astype(np.int64)
    cand[:, 7] = -5 * step
    cand[:, 8] = n_ts * TS_DEC
    if bursty:
        bb[3, n_ts // 2:] = 0.0
        cand[3, :7] = (n_ts // 2 // MF_S - np.arange(7) * 100) * step
    bank = _bank(rng)
    fidx = rng.integers(0, bank.shape[0], (b, m)).astype(np.int64)
    return bb, cand, fidx, bank


def _xla(bb, cand, fidx, bank, use_pallas=False):
    return np.asarray(jsync.pilot_rescore(
        jnp.asarray(bb), jnp.asarray(cand, jnp.int32),
        jnp.asarray(fidx, jnp.int32), bank, MF_S, TS_DEC, PRE_SPAN,
        use_pallas=use_pallas))


def _port(bb, cand, fidx, bank):
    return sync.pilot_rescore(torch.as_tensor(bb), torch.as_tensor(cand),
                              torch.as_tensor(fidx), torch.as_tensor(bank),
                              MF_S, TS_DEC, PRE_SPAN).numpy()


@pytest.mark.parametrize("bursty", [False, True])
def test_pilot_rescore_matches_xla(bursty):
    bb, cand, fidx, bank = _case(bursty)
    want = _xla(bb, cand, fidx, bank)
    got = _port(bb, cand, fidx, bank)
    assert got.shape == want.shape == cand.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # the plain kernel version on the decimated row and the starts the XLA
    # path computes (here unclipped: the function clips them itself)
    bb_dec = torch.as_tensor(bb[:, ::MF_S])
    idx0 = torch.as_tensor((cand + PRE_SPAN) // (MF_S * TS_DEC))
    ref = kernels.pilot_cand_score_ref(bb_dec, idx0, torch.as_tensor(fidx),
                                       torch.as_tensor(bank)).numpy()
    np.testing.assert_array_equal(ref, got)
    if not bursty:
        np.testing.assert_allclose(got, _xla(bb, cand, fidx, bank, True),
                                   rtol=2e-5, atol=1e-5)


def test_bursty_row_follows_xla_floor():
    """Seven candidates in the loud half of a row, one in a half 42 dB
    quieter. Per symbol the loud segments hold ~272 units of energy, so the
    XLA floor is ~1e-4 x 238 = 0.024 and the Pallas floor 1e-4 x 136 x the
    row's mean power 1 = 0.0136; the quiet symbols hold ~272 x 6.6e-5 =
    0.018, between the two. The port scores that candidate 0 as the XLA path
    does; the Pallas kernel does not."""
    rng = np.random.default_rng(11)
    n_ts, m = 6000, 8
    bank = _bank(rng, f_n=3)
    bb = (rng.standard_normal((1, n_ts))
          + 1j * rng.standard_normal((1, n_ts))).astype(np.complex64)
    bb[0, n_ts // 2:] *= np.float32(np.sqrt(6.6e-5))
    step = MF_S * TS_DEC
    cand = (np.arange(m) * 40 * step - PRE_SPAN)[None].astype(np.int64)
    cand[0, -1] = (n_ts // 2 + 200) * TS_DEC - PRE_SPAN       # quiet half
    fidx = np.zeros((1, m), np.int64)
    want = _xla(bb, cand, fidx, bank)
    got = _port(bb, cand, fidx, bank)
    pallas = _xla(bb, cand, fidx, bank, use_pallas=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[0, -1] == 0.0 and (got[0, :-1] > 0).all()
    assert pallas[0, -1] > 0.1
    np.testing.assert_allclose(pallas[0, :-1], got[0, :-1], rtol=2e-5,
                               atol=1e-5)


def test_silent_row_scores_zero():
    bank = _bank(np.random.default_rng(4), f_n=2, nsym=4)
    bb = np.zeros((2, 4000), np.complex64)
    cand = np.zeros((2, 3), np.int64)
    got = _port(bb, cand, cand, bank)
    np.testing.assert_array_equal(got, _xla(bb, cand, cand, bank))
    assert (got == 0).all()
