"""The plain versions of the CUDA kernels for the front-end FIR and the
matched-filter scores against the Pallas kernels they replace (interpret
mode on the CPU; deep_mf_max and pilot_cand_score are held to theirs in
tests/test_torch_coherent.py and tests/test_torch_pilot.py). The kernels themselves are held against
their plain versions on the card in tests/test_torch_cuda.py.

Tolerances: the front-end FIR atol 1e-5 / rtol 1e-4 (float32 sums in a
different order); the matched-filter scores rtol/atol 1e-3 with equal argmax
lags (FFT versus direct correlation, as tests/test_pallas.py holds the
Pallas kernel to the XLA path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.dsp import pallas_kernels
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.fec import ldpc


@pytest.fixture(scope="module")
def geom():
    return build_geometry(0, with_pre_eq=False)


def _osc(g, n):
    ph = (2 * np.pi * g.fc / g.fs) * np.arange(n, dtype=np.float64)
    return (np.sqrt(2) * (np.cos(ph) + 1j * np.sin(ph))).astype(np.complex64)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_mix_fir_decimate_ref_matches_pallas(geom, stride):
    rng = np.random.default_rng(0)
    pb = rng.standard_normal((3, 8192)).astype(np.float32)
    taps = geom.fir_rx_ts.astype(np.float32)
    want = pallas_kernels.mix_fir_decimate(jnp.asarray(pb), jnp.asarray(taps),
                                           geom.fs, geom.fc, stride=stride,
                                           interpret=True)
    got = kernels.mix_fir_decimate(torch.as_tensor(pb),
                                   torch.as_tensor(_osc(geom, 8192)),
                                   torch.as_tensor(taps), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("cfg", [3, 9])
def test_mix_fir_decimate_row_starts_match_frame_extraction(cfg):
    """Per-row-start form == the JAX RxChain's data-FIR frame extraction,
    including starts clipped at both buffer edges."""
    from mercury_tpu.modem.rx import RxChain as JaxRx
    from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
    from mercury_tpu_torch.modem.rx import RxChain

    g = build_geometry(cfg)
    rng = np.random.default_rng(cfg)
    n = g.nofdm * g.buffer_nsymb * g.interp
    pb = rng.standard_normal((4, n)).astype(np.float32)
    frame = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
    delay = np.array([0, 1234, n - frame, n], dtype=np.int64)
    want = JaxRx(g).extract_frame_decimated_pb(
        jnp.asarray(pb), jnp.asarray(delay, jnp.int32), g.nsymb)
    rx = RxChain(port_geometry(cfg), device="cpu")
    got = rx.extract_frame_decimated_pb(
        torch.as_tensor(pb), torch.as_tensor(delay), g.nsymb)
    assert got.shape == want.shape == (4, frame // g.interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("stride", [1, 4])
def test_mix_fir_decimate_row_freq_matches_jax_mix(stride):
    """Per-row frequency form (plain version) == the JAX chain's
    mix(pb, f) at fc + f[b], then fir_same[::stride] ("same" form) or its
    frame extraction over the mixed IQ (per-row starts), over a CONFIG_9
    buffer (92480 samples). JAX mixes in float32 phase: at up to 1.9e4 rad
    that is ~1.1e-3 rad of rounding, so the outputs agree within 3e-3 of
    the output scale; the port's phase is float64 (ROADMAP §3). A row at
    0 Hz equals the form without offsets bit for bit."""
    from mercury_tpu.dsp import ops as jops
    from mercury_tpu.modem.rx import RxChain as JaxRx

    g = build_geometry(9)
    jax_rx = JaxRx(g)
    rng = np.random.default_rng(stride)
    n = g.nofdm * g.buffer_nsymb * g.interp
    pb = rng.standard_normal((3, n)).astype(np.float32)
    freq = np.array([0.0, 20.0, -45.0], np.float32)
    taps = g.fir_rx_data.astype(np.float32)
    iq = jax_rx.mix(jnp.asarray(pb), jnp.asarray(freq))
    args = (torch.as_tensor(pb), torch.as_tensor(_osc(g, n)),
            torch.as_tensor(taps), stride)
    f_t = torch.as_tensor(freq)
    ntaps = len(taps)
    frame = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
    delay = np.array([0, 2000, n - frame], np.int64)
    cases = [({}, np.asarray(jops.fir_same(iq, jnp.asarray(taps)))[:, ::stride])]
    if stride == g.interp:
        cases.append((dict(start=torch.as_tensor(delay),
                           n_out=frame // g.interp,
                           offset=ntaps - 1 - (ntaps - 1) // 2),
                      np.asarray(jax_rx.extract_frame_decimated(
                          iq, jnp.asarray(delay, jnp.int32), g.nsymb))))
    for row, want in cases:
        got = kernels.mix_fir_decimate(*args, **row, freq=f_t, fs=g.fs)
        assert got.shape == want.shape
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, atol=3e-3 * scale)
        assert torch.equal(got[0], kernels.mix_fir_decimate(*args, **row)[0])


def _deep_case(seed, a, lp, s, window, rows, plant, silence=None):
    rng = np.random.default_rng(seed)
    bank = (rng.standard_normal((a, lp, s))
            + 1j * rng.standard_normal((a, lp, s))).astype(np.complex64)
    seg_len = 2 * window + lp * s
    seg = (rng.standard_normal((rows, seg_len))
           + 1j * rng.standard_normal((rows, seg_len))).astype(np.complex64)
    row, hyp, lag = plant
    seg[row, lag: lag + lp * s] += 5.0 * bank[hyp].reshape(-1)
    if silence is not None:
        seg[silence, :40] = 0.0
    return seg, bank


@pytest.mark.parametrize("case", [
    # tests/test_pallas.py:212 (planted peak + silence row)
    dict(seed=15, a=3, lp=4, s=96, window=280, rows=5, plant=(2, 1, 150),
         silence=4, nfft=1024),
    # tests/test_pallas.py:245 (undersized transform grown inside)
    dict(seed=23, a=2, lp=4, s=40, window=200, rows=3, plant=(1, 0, 77),
         nfft=256),
])
def test_deep_mf_score_ref_matches_pallas(case):
    case = dict(case)
    nfft = case.pop("nfft")
    seg, bank = _deep_case(**case)
    window = case["window"]
    want = np.asarray(pallas_kernels.deep_mf_score(
        jnp.asarray(seg), bank, window, nfft, interpret=True))
    got = kernels.deep_mf_score(torch.as_tensor(seg), torch.as_tensor(bank),
                                window, nfft).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    row, hyp, lag = case["plant"]
    assert got[row, hyp].argmax() == lag


def _toeplitz_scores(seg, packed, s, window):
    """deep_mf_score as the CUDA kernels compute it: per part l the Toeplitz
    window X_l[d, 2k + r] = (Re, Im)[r] of seg[d + l*S + k] times the
    packed bank, |.| of each (Re, Im) column pair, energy-gated, summed over
    l -> [B, N/2, 2w+1]."""
    b = seg.shape[0]
    lp, _, n = packed.shape
    n_cand = 2 * window + 1
    x = torch.view_as_real(seg)
    ce, ef = kernels._energy_terms(seg, s)
    score = torch.zeros((b, n // 2, n_cand))
    for l in range(lp):
        win = x[:, l * s: l * s + n_cand + s - 1].unfold(1, s, 1)
        xl = win.transpose(-1, -2).reshape(b, n_cand, 2 * s)
        c = (xl @ packed[l]).reshape(b, n_cand, n // 2, 2)
        c = torch.linalg.vector_norm(c, dim=-1).transpose(1, 2)
        e = ce[:, l * s + s: l * s + s + n_cand] - ce[:, l * s: l * s + n_cand]
        w = torch.where(e > ef, torch.rsqrt(torch.maximum(e, ef)), 0.0)
        score = score + c * w[:, None]
    return score


@pytest.mark.parametrize("case", [
    # CONFIG_0's layout (Lp 1), 2A = 10 padded to 16, odd S
    dict(seed=3, a=5, lp=1, s=67, window=40, rows=3, plant=(1, 4, 33),
         silence=2),
    # four parts, 2A = 6 padded to 8
    dict(seed=4, a=3, lp=4, s=16, window=30, rows=2, plant=(0, 2, 7)),
    # 61 hypotheses as CONFIG_0's CFO grid: 122 columns padded to 128
    dict(seed=5, a=61, lp=1, s=12, window=20, rows=2, plant=(1, 60, 3)),
])
def test_packed_bank_toeplitz_gemm_matches_plain(case):
    """The packed bank the CUDA kernels multiply, times the Toeplitz windows
    in plain torch, reproduces deep_mf_score_ref; the padded columns are
    zero; the kernels' operand is the same matrix in wgmma's K-major core
    matrices, rounded to TF32."""
    seg, bank = (torch.as_tensor(x) for x in _deep_case(**case))
    a, lp, s = bank.shape
    packed = kernels.dmf_pack_bank(bank)
    n = -(-2 * a // 8) * 8
    assert packed.shape == (lp, 2 * s, n) and packed.dtype == torch.float32
    assert (packed[..., 2 * a:] == 0).all()
    got = _toeplitz_scores(seg, packed, s, case["window"])
    assert (got[:, a:] == 0).all()
    want = kernels.deep_mf_score_ref(seg, bank, case["window"])
    torch.testing.assert_close(got[:, :a], want, rtol=1e-5, atol=1e-5)
    row, hyp, lag = case["plant"]
    assert int(got[row, hyp].argmax()) == lag
    kb = kernels._dmf_kernel_bank(bank)
    s4 = -(-s // 4)
    assert kb.shape == (lp, s4, n // 8, 2, 8, 4) and kb.is_contiguous()
    # [l, k4, G, h, row, j] is row 2(4*k4 + j) + h, column 8G + row
    full = torch.nn.functional.pad(packed, (0, 0, 0, 8 * s4 - 2 * s))
    want = full.reshape(lp, s4, 4, 2, n // 8, 8).permute(0, 1, 4, 3, 5, 2)
    torch.testing.assert_close(kb, want, rtol=2 ** -11, atol=0)
    assert ((kb.view(torch.int32) & 0x1FFF) == 0).all()


# deep_mf_best's cases: the refine's layout (3 aliases, four parts), c2f's
# 5-row bank with a silent row, 16 hypotheses of two short parts (a tile
# taller than S: the kernel adds the parts in passes), one part with a
# duplicated template
BEST_CASES = [
    dict(seed=41, a=3, lp=4, s=136, window=272, rows=3, plant=(1, 2, 300)),
    dict(seed=42, a=5, lp=4, s=40, window=120, rows=3, plant=(0, 4, 17),
         silent=2),
    dict(seed=43, a=16, lp=2, s=24, window=90, rows=2, plant=(1, 15, 0)),
    dict(seed=44, a=4, lp=1, s=67, window=60, rows=2, plant=(0, 1, 33),
         twin=(3, 1)),
]
BEST_IDS = ["refine", "c2f-silent", "16-hypotheses", "one-part-twin"]


def _best_case(case):
    case = dict(case)
    silent, twin = case.pop("silent", None), case.pop("twin", None)
    seg, bank = _deep_case(**case)
    if twin is not None:
        bank[twin[0]] = bank[twin[1]]
    if silent is not None:
        seg[silent] = 0.0
    return torch.as_tensor(seg), torch.as_tensor(bank)


@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("case", BEST_CASES, ids=BEST_IDS)
def test_deep_mf_best_plain_matches_surface_and_jax(case, one_thread):
    """deep_mf_best's plain version is deep_mf_score_ref's first argmax over
    the lags and the score there; the JAX package's
    sync.matched_filter_refine_bank finds the same lags on the same numpy
    inputs, scores / Lp within rtol 1e-4 (its own FFT scoring). A silent
    row's lags are all gated to 0, so lag 0 wins; a duplicated template
    takes its twin's lag and score."""
    from mercury_tpu.modem import sync as jsync
    seg, bank = _best_case(case)
    window, lp = case["window"], case["lp"]
    lag, score = kernels.deep_mf_best(seg, bank, window)
    surface = kernels.deep_mf_score_ref(seg, bank, window)
    assert lag.dtype == torch.int64 and score.dtype == torch.float32
    assert torch.equal(lag, surface.argmax(-1))
    assert torch.equal(score, torch.gather(surface, -1, lag[..., None])[..., 0])
    start = np.arange(seg.shape[0]) * 7
    d_j, s_j = jsync.matched_filter_refine_bank(
        jnp.asarray(seg.numpy()), jnp.asarray(start), bank.numpy(), window)
    np.testing.assert_array_equal(lag.numpy() + start[:, None], np.asarray(d_j))
    np.testing.assert_allclose(score.numpy() / lp, np.asarray(s_j), rtol=1e-4,
                               atol=1e-6)
    row, hyp, at = case["plant"]
    assert int(lag[row, hyp]) == at
    if "silent" in case:
        assert (lag[case["silent"]] == 0).all()
        assert (score[case["silent"]] == 0).all()
    if "twin" in case:
        a, b = case["twin"]
        assert torch.equal(lag[:, a], lag[:, b])
        assert torch.equal(score[:, a], score[:, b])


@pytest.mark.parametrize("case", BEST_CASES[:3], ids=BEST_IDS[:3])
def test_best_bank_one_gemm_over_toeplitz_rows(case, one_thread):
    """deep_mf_best's operand: every part's columns side by side (column
    l*2A + 2a + r), the TF32 values of dmf_pack_bank's parts, in wgmma's
    core matrices. One product of each Toeplitz row r of the segment with
    it, |.| of each column pair gated by row r's energy and added to lag
    r - l*S, reproduces deep_mf_score_ref."""
    seg, bank = _best_case(case)
    a, lp, s = bank.shape
    window = case["window"]
    n_cand = 2 * window + 1
    n = -(-2 * lp * a // 8) * 8
    s4 = -(-s // 4)
    kb = kernels._dmf_best_bank(bank)
    assert kb.shape == (s4, n // 8, 2, 8, 4) and kb.is_contiguous()
    # [k4, G, h, row, j] is row 2(4*k4 + j) + h, column 8G + row
    mat = kb.permute(0, 4, 2, 1, 3).reshape(8 * s4, n)[:2 * s]
    packed = kernels.dmf_pack_bank(bank)[..., :2 * a]       # [Lp, 2S, 2A]
    side = torch.cat(list(packed), dim=1)                  # [2S, 2*Lp*A]
    assert torch.equal(mat[:, :2 * lp * a], kernels._tf32(side))
    assert (mat[:, 2 * lp * a:] == 0).all()
    n_rows = n_cand + (lp - 1) * s
    x = torch.view_as_real(seg)[:, :n_rows + s - 1].unfold(1, s, 1)
    rows = x.transpose(-1, -2).reshape(seg.shape[0], n_rows, 2 * s)
    c = torch.linalg.vector_norm(
        (rows @ side).reshape(seg.shape[0], n_rows, lp, a, 2), dim=-1)
    ce, ef = kernels._energy_terms(seg, s)
    e = ce[:, s: s + n_rows] - ce[:, :n_rows]
    w = torch.where(e > ef, torch.rsqrt(torch.maximum(e, ef)), 0.0)
    v = c * w[..., None, None]                             # [B, rows, Lp, A]
    got = sum(v[:, l * s: l * s + n_cand, l] for l in range(lp))
    want = kernels.deep_mf_score_ref(seg, bank, window)
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=1e-5,
                               atol=1e-5)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -12, one + 2 ** -11, -(one + 2 ** -11),
                      one + 3 * 2 ** -11, 0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + 2 ** -10, -(one + 2 ** -10),
                         one + 2 ** -9, 0.0, 3.0], dtype=torch.float32)
    assert torch.equal(kernels._tf32(x), want)


def test_cpu_tensors_take_the_plain_versions(geom):
    """On the CPU the wrappers return their plain versions and count no
    kernel launch; on any other non-CUDA device they raise."""
    kernels.reset_launch_counts()
    seg, bank = _deep_case(1, 2, 2, 16, 20, 2, (0, 1, 5))
    s = kernels.deep_mf_score(torch.as_tensor(seg), torch.as_tensor(bank), 20)
    torch.testing.assert_close(s, kernels.deep_mf_score_ref(
        torch.as_tensor(seg), torch.as_tensor(bank), 20), rtol=0, atol=0)
    pb = torch.randn(2, 512)
    osc = torch.as_tensor(_osc(geom, 512))
    taps = torch.as_tensor(geom.fir_rx_ts.astype(np.float32))
    kernels.mix_fir_decimate(pb, osc, taps, 4)
    smax, sarg = kernels.deep_mf_max(torch.as_tensor(seg),
                                     torch.as_tensor(bank), 20)
    torch.testing.assert_close(smax, s.amax(1), rtol=0, atol=0)
    torch.testing.assert_close(sarg, s.argmax(1), rtol=0, atol=0)
    bb = torch.as_tensor(seg)
    idx0 = torch.tensor([[0, 3], [9, 1]])
    pil = torch.as_tensor(bank)
    torch.testing.assert_close(
        kernels.pilot_cand_score(bb, idx0, idx0 % 2, pil),
        kernels.pilot_cand_score_ref(bb, idx0, idx0 % 2, pil), rtol=0, atol=0)
    plan = ldpc.pack_plan(4)
    llr = torch.randn(2, plan.n) * 4.0
    for got, want in zip(kernels.ldpc_layered(llr, plan, 3, soft=True),
                         kernels.layered_decode_ref(llr, plan, 3, soft=True)):
        assert torch.equal(got, want)
    lag, best = kernels.deep_mf_best(torch.as_tensor(seg),
                                     torch.as_tensor(bank), 20)
    torch.testing.assert_close(lag, s.argmax(-1), rtol=0, atol=0)
    torch.testing.assert_close(best, s.amax(-1), rtol=0, atol=0)
    assert set(kernels.LAUNCHES) == {"mix_fir_decimate", "deep_mf_score",
                                     "deep_mf_max", "deep_mf_best",
                                     "pilot_cand_score", "ldpc_layered"}
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.mix_fir_decimate(pb.to("meta"), osc.to("meta"),
                                 taps.to("meta"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.deep_mf_score(torch.as_tensor(seg).to("meta"),
                              torch.as_tensor(bank).to("meta"), 20)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.deep_mf_max(torch.as_tensor(seg).to("meta"),
                            torch.as_tensor(bank).to("meta"), 20)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.deep_mf_best(torch.as_tensor(seg).to("meta"),
                             torch.as_tensor(bank).to("meta"), 20)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.pilot_cand_score(bb.to("meta"), idx0.to("meta"),
                                 idx0.to("meta"), pil.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.ldpc_layered(llr.to("meta"), plan, 3)
