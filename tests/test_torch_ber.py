"""The port's BER harness against the JAX package's (`channel/ber.py`):
both draw payloads and baseband bits from the same numpy seeds, so they
send the same bytes; the noise comes from a torch.Generator in the port and
from jax.random in JAX, so FER and BER agree only where both decode every
frame (the points below). The baseband step's two halves are held against
the JAX functions the JAX step composes, on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.channel.ber import BerHarness as JaxHarness
from mercury_tpu.dsp import ops as jops
from mercury_tpu.fec import ldpc as jldpc
from mercury_tpu.modem import psk as jpsk
from mercury_tpu_torch.channel.ber import BerHarness, BerPoint, BerSweep


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _record_payloads(tx, to_numpy):
    """Wrap tx.transmit to keep every payload batch it is given."""
    seen = []
    transmit = tx.transmit

    def recorder(payload, *args, **kwargs):
        seen.append(to_numpy(payload))
        return transmit(payload, *args, **kwargs)

    tx.transmit = recorder
    return seen


@pytest.mark.parametrize("cfg,ctrl,esn0,fixed", [
    (9, False, 10.0, False), (9, False, 10.0, True),
    (100, True, -9.0, True)])
def test_run_point_matches_jax(cfg, ctrl, esn0, fixed):
    """A clean point (two batches of two through receive, one through
    decode_at): FER 0 on both
    harnesses, the same payload bytes sent; fixed_delay decodes at the
    known delay through decode_at (OFDM, and CONFIG_100's control
    frames)."""
    ours = BerHarness(cfg, batch=2, ctrl=ctrl, device="cpu")
    theirs = JaxHarness(cfg, batch=2, ctrl=ctrl)
    sent = _record_payloads(ours.tx, lambda p: p.cpu().numpy())
    sent_j = _record_payloads(theirs.tx, np.asarray)
    n = 2 if fixed else 4
    p = ours.run_point(esn0, n, fixed_delay=fixed)
    p_j = theirs.run_point(esn0, n, fixed_delay=fixed)
    assert (p.frames, p.bits) == (p_j.frames, p_j.bits) == (
        n, n * ours.geom.frame_bytes * 8)
    assert p.fer == p_j.fer == 0.0 and p.ber == p_j.ber == 0.0
    assert len(sent) == len(sent_j) == n // 2
    for a, b in zip(sent, sent_j):
        np.testing.assert_array_equal(a, b)


def test_baseband_point_and_mfsk_raise():
    """tests/test_obs_gbf.py:36-41 restated: baseband CONFIG_0 at 2 dB has
    FER 0 on both; an MFSK mode has no baseband harness."""
    p = BerHarness(0, batch=8, device="cpu").run_point_baseband(2.0, 8)
    assert p.fer == 0.0 and p.frames == 8
    assert JaxHarness(0, batch=8).run_point_baseband(2.0, 8).fer == 0.0
    with pytest.raises(ValueError):
        BerHarness(100, batch=4, device="cpu").run_point_baseband(0.0, 4)


def test_baseband_halves_match_jax():
    """bb_transmit equals the JAX step's TX composition (LDPC encode, bit
    interleave, PSK map, t/f interleave, pilots, OFDM mod / sqrt(Nfft)) to
    1e-5; bb_bit_errors equals the errors of the JAX chain's
    bb_decode_bits on the same noisy symbols (CONFIG_9 at 2 dB Es/N0,
    where some rows need several sweeps)."""
    ours = BerHarness(9, batch=4, device="cpu")
    theirs = JaxHarness(9, batch=4)
    g = theirs.geom
    rng = np.random.default_rng(3)
    n_real = g.n_bits - g.ldpc_p
    bits = rng.integers(0, 2, (4, n_real)).astype(np.int32)
    td = ours.bb_transmit(torch.as_tensor(bits, dtype=torch.int64))
    code = theirs.tx.code
    u = jnp.concatenate([bits, bits[:, : g.n_virtual]], axis=-1)
    cw = jldpc.encode(code, u)
    tx_bits = jnp.concatenate([bits, cw[:, code.k:]], axis=-1)
    syms = jpsk.mod(jnp.take(tx_bits, jnp.asarray(g.bit_perm), axis=-1),
                    theirs.tx._const)
    syms = jnp.take(syms, jnp.asarray(g.tf_perm), axis=-1)
    flat = np.zeros((4, g.nsymb * g.nc), np.complex64)
    flat[:, g.data_cells] = np.asarray(syms)
    flat[:, g.pilot_cells] = g.pilot_seq.astype(np.complex64)[None]
    want = jops.ofdm_mod(jnp.asarray(flat.reshape(4, g.nsymb, g.nc)),
                         jnp.asarray(g.pad_map), g.nfft, g.ngi) / np.sqrt(g.nfft)
    np.testing.assert_allclose(td.numpy(), np.asarray(want), atol=1e-5)
    sigma = 10 ** (-2.0 / 20.0)
    noise = (sigma / np.sqrt(2)) * (rng.standard_normal(td.shape)
                                    + 1j * rng.standard_normal(td.shape))
    rx_td = ((np.asarray(want) + noise) * np.sqrt(g.nfft)).astype(np.complex64)
    errs = ours.bb_bit_errors(torch.as_tensor(rx_td),
                              torch.as_tensor(bits, dtype=torch.int64))
    grid = jops.ofdm_demod(jnp.asarray(rx_td), jnp.asarray(g.pad_map),
                           g.nfft, g.ngi)
    want_errs = np.sum(np.asarray(jax.jit(theirs.rx.bb_decode_bits)(grid))
                       != bits, axis=-1)
    np.testing.assert_array_equal(errs.numpy(), want_errs)


def test_front_end_delta_matches_jax():
    """CONFIG_0's front-end conversion within 0.01 dB of the JAX
    harness's (the same payload and numpy noise through both front
    ends)."""
    d = BerHarness(0, batch=1, device="cpu").front_end_delta(8)
    d_j = JaxHarness(0, batch=1).front_end_delta(8)
    assert abs(d - d_j) < 0.01
    assert -5.2 < d < -4.8


def test_sweep_early_exit_and_waterfall():
    """sweep stops at the first point whose FER reaches early_exit_fer;
    BerSweep.waterfall is the lowest Es/N0 under the threshold."""
    h = BerHarness(9, batch=2, device="cpu")
    s = h.sweep([9.0, 12.0], n_frames=2)
    assert [p.esn0_db for p in s.points] == [9.0]
    assert s.points[0].fer == 0.0
    sw = BerSweep(9, [BerPoint(1.0, 10, 5, 50, 1000),
                      BerPoint(2.0, 10, 0, 0, 1000),
                      BerPoint(1.5, 10, 0, 3, 1000)])
    assert sw.waterfall() == 1.5 and sw.waterfall(0.0) is None
    assert sw.points[0].fer == 0.5 and sw.points[0].ber == 0.05
