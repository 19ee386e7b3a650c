"""Decision-directed re-estimation, the QAM and zero-forcing grid statistics
and the MER SNR of mercury_tpu_torch's RxChain against the JAX RxChain, on
carrier grids built once in numpy and fed to both (the baseband harness: the
TX grid times a smooth frequency-selective channel, plus complex AWGN of
variance 10^(-EsN0/10) per cell; no sync chain).

Tolerances: grid-stage outputs (equalized grid, variances, mean |H|, slope,
LLRs, equalized data) rtol 1e-4 / atol 1e-4 (float32 sums in another
order); re-encoded symbols exact; the MER SNR within 1e-3 dB. Decodes: the
same rows decode, to the same bits. A row whose first LDPC decode fails
ends in the chaotic state of 50 non-converging sweeps, which last-ulp
differences steer: the LLRs of the two packages differ by ~1e-5 (float32
sums in another order), and even the min-sum decoder, exact on equal
inputs, then ends such rows apart. The re-decode starts from those
decisions, so which rows it recovers is held on these inputs, not in
general (ROADMAP.md §3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.fec.tables import load_code
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.rx import RxChain

B = 8
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The LDPC loop calls tanh on small tensors, which MKL threads at a
    cost far above the work; one thread keeps the CPU decodes short."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bb_grid(g, bits: np.ndarray, esn0_db: float, seed: int,
            taper: float = 0.0) -> np.ndarray:
    """Info bits [B, nReal] -> received carrier grid [B, S, Nc] complex64:
    LDPC encode (virtual-bit duplication, the rate's generator), bit
    interleave, map, tf-interleave, pilots; a channel of amplitude
    1 + taper cos(2 pi c / Nc) and phase 0.01 c across carriers; AWGN."""
    code = load_code(g.spec.ldpc_rate_num)
    u = np.concatenate([bits, bits[:, : g.n_virtual]], -1)
    parity = (u @ code.gen.T.astype(np.int64)) % 2
    tx_bits = np.concatenate([bits, parity], -1)[:, g.bit_perm]
    nb = int(np.log2(len(g.constellation)))
    idx = tx_bits.reshape(len(bits), -1, nb) @ (1 << np.arange(nb)[::-1])
    flat = np.zeros((len(bits), g.nsymb * g.nc), np.complex128)
    flat[:, g.data_cells] = np.asarray(g.constellation)[idx][:, g.tf_perm]
    flat[:, g.pilot_cells] = g.pilot_seq
    c = np.arange(g.nsymb * g.nc) % g.nc
    chan = (1 + taper * np.cos(2 * np.pi * c / g.nc)) * np.exp(0.01j * c)
    rng = np.random.default_rng(seed)
    noise = np.sqrt(10 ** (-esn0_db / 10) / 2) * (
        rng.standard_normal(flat.shape) + 1j * rng.standard_normal(flat.shape))
    return (flat * chan + noise).reshape(-1, g.nsymb, g.nc).astype(
        np.complex64)


def random_bits(g, seed: int) -> np.ndarray:
    return np.random.default_rng(1000 + seed).integers(0, 2, (B, g.n_real))


@pytest.fixture(scope="module")
def chains():
    cache = {}

    def get(cfg, estimator="auto", **kw):
        key = (cfg, estimator, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = (
                build_geometry(cfg, estimator=estimator),
                JaxRx(build_geometry(cfg, estimator=estimator), **kw),
                RxChain(port_geometry(cfg, estimator=estimator),
                        device="cpu", **kw))
        return cache[key]

    return get


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# the replaced cases of test_torch_rx.py's out-of-slice list: each option
# the port now takes resolves as the JAX chain resolves it
@pytest.mark.parametrize("cfg,estimator,kwargs", [
    (16, "auto", {}),                   # 32QAM: DD and BICM-ID on
    (11, "auto", {}),                   # 8PSK: DD on
    (10, "auto", {"dd_window": (5, 9), "dd_passes": 2}),
    (13, "auto", {"dd": False}),        # QAM without DD: MER SNR still
    (15, "reference", {}),              # zero-forcing: no DD
    (16, "reference", {}),              # zero-forcing with BICM-ID
    (9, "auto", {"bicm_iters": 1}),
    (9, "auto", {"ldpc_algo": "spa"}),
    (16, "auto", {"ldpc_algo": "layered-minsum"}),
    (16, "auto", {"ldpc_algo": "minsum"}),   # flooding: BICM-ID off
    (0, "auto", {}),                    # rate 1/16: llr_scale 0.85
])
def test_option_policy_matches_jax(cfg, estimator, kwargs):
    jax_rx = JaxRx(build_geometry(cfg, estimator=estimator), **kwargs)
    rx = RxChain(port_geometry(cfg, estimator=estimator), device="cpu",
                 **kwargs)
    for name in ("dd", "bicm_iters", "llr_scale", "dd_window", "dd_passes",
                 "ldpc_algo"):
        assert getattr(rx, name) == getattr(jax_rx, name), name


@pytest.mark.parametrize("cfg,estimator,kwargs", [
    (16, "reference", {"dd": True}),          # DD needs the LS estimator
    (16, "auto", {"dd_window": (4, 9)}),      # spans must be odd
    (9, "auto", {"ldpc_algo": "spa", "bicm_iters": 1}),
    (9, "auto", {"ldpc_algo": "gbf"}),
])
def test_invalid_options_raise_as_in_jax(cfg, estimator, kwargs):
    with pytest.raises(ValueError):
        JaxRx(build_geometry(cfg, estimator=estimator), **kwargs)
    with pytest.raises(ValueError):
        RxChain(port_geometry(cfg, estimator=estimator), device="cpu",
                **kwargs)


@pytest.mark.parametrize("cfg,estimator", [(13, "auto"), (16, "auto"),
                                           (15, "reference")])
def test_grid_stats_internal_matches_jax(chains, cfg, estimator):
    """QAM modes equalize by H itself and zero-forcing takes its noise from
    the leave-one-out pilot residual. On CONFIG_13, dividing by H/|H| (the
    PSK modes' amplitude restoration) would leave the channel's amplitude
    on the cells: the equalized pilots must sit on their sequence."""
    g, jax_rx, rx = chains(cfg, estimator)
    grid = bb_grid(g, random_bits(g, cfg), 22.0, cfg, taper=0.5)
    got = rx._grid_stats_internal(torch.as_tensor(grid))
    want = jax_rx._grid_stats_internal(jnp.asarray(grid))
    for name, a, w in zip(("eq", "variance", "mean_h", "var_full", "flat",
                           "slope"), got, want):
        _close(a.numpy(), w, err_msg=name, **TOL)
    eq_pil = got[0].numpy()[:, g.pilot_cells]
    pilot_err = np.abs(eq_pil - g.pilot_seq).mean()
    if cfg == 13:
        # dividing by H/|H| instead leaves the 1 +- 0.5 taper on the cells
        flat_pil = got[4].numpy()[:, g.pilot_cells]
        phase_only = eq_pil * np.abs(flat_pil / eq_pil)
        assert np.abs(phase_only - g.pilot_seq).mean() > 2 * pilot_err


@pytest.mark.parametrize("cfg", [11, 13, 16])
def test_dd_demod_reencode_and_mer_match_jax(chains, cfg):
    """On one grid and its wire bits: the re-encoded symbols exactly, the
    first demap (decode_ofdm), the DD demod's (LLRs, data, variance, mean_h,
    var_full), and the MER SNR."""
    g, jax_rx, rx = chains(cfg)
    bits = random_bits(g, cfg)
    grid = bb_grid(g, bits, 20.0, cfg)
    wire = torch.as_tensor(bits)
    ideal = rx._reencode_symbols(wire)
    ideal_j = jax_rx._reencode_symbols(jnp.asarray(bits.astype(np.int32)))
    np.testing.assert_array_equal(ideal.numpy(), np.asarray(ideal_j))
    # the calibrated first demap (LLRs, SNR, mean |H|, data)
    for name, a, w in zip(("llr", "snr", "mean_h", "data"),
                          rx.decode_ofdm(torch.as_tensor(grid)),
                          jax_rx.decode_ofdm(jnp.asarray(grid))):
        _close(a.numpy(), w, err_msg=name, **TOL)
    _llr, (flat, slope, data, *_r) = rx._ofdm_llr(torch.as_tensor(grid))
    _llr_j, (flat_j, slope_j, data_j, *_rj) = jax_rx._ofdm_llr(
        jnp.asarray(grid))
    got = rx._dd_demod(flat, slope, wire)
    want = jax_rx._dd_demod(flat_j, slope_j,
                            jnp.asarray(bits.astype(np.int32)))
    for name, a, w in zip(("llr", "data", "variance", "mean_h", "var_full"),
                          got, want):
        _close(a.numpy(), w, err_msg=name, **TOL)
    real = wire ^ rx._dispersal[None]
    mer = rx._mer_snr(real, got[1])
    mer_j = jax_rx._mer_snr(jnp.asarray(real.numpy().astype(np.int32)),
                            want[1])
    _close(mer.numpy(), mer_j, atol=1e-3, rtol=0)
    # decisions equal to the sent bits: the MER is the grid's 20 dB, less
    # the estimation noise
    assert (mer.numpy() > 17.0).all()


def _first_pass_errors(g, bits, grid):
    plain = RxChain(port_geometry(g.spec.config), device="cpu", dd=False,
                    bicm_iters=0)
    return (plain.bb_decode_bits(torch.as_tensor(grid)).numpy()
            != bits).any(-1)


def test_bb_decode_bits_dd_recovers_rows(chains):
    """CONFIG_11 (8PSK 8/16) at 4.5 dB: some first decodes fail and the DD
    pass recovers at least one row. The same rows decode in both packages,
    and no row that decoded at first is lost."""
    g, jax_rx, rx = chains(11)
    assert rx.dd and rx.bicm_iters == 0
    bits = random_bits(g, 0)
    grid = bb_grid(g, bits, 4.5, 0)
    got = rx.bb_decode_bits(torch.as_tensor(grid)).numpy()
    want = np.asarray(jax_rx.bb_decode_bits(jnp.asarray(grid)))
    err = (got != bits).any(-1)
    np.testing.assert_array_equal(err, (want != bits).any(-1))
    np.testing.assert_array_equal(got[~err], want[~err])
    err1 = _first_pass_errors(g, bits, grid)
    assert not (err & ~err1).any()
    assert err.sum() < err1.sum()
