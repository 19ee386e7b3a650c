"""The CUDA kernels against their plain versions, on the card (marker
`cuda`; skipped without a GPU, since a CUDA kernel has no CPU mode).

This file imports no JAX, so it runs on a machine with the card and no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Tolerances as in tests/test_torch_kernels.py: FIR atol 1e-5 / rtol 1e-4,
matched-filter scores and their max over the bank rtol/atol 1e-3 with equal
argmax lags (on every row in the first score case, on the planted rows and
wherever the top two lags differ by more than 1e-3 in the ragged cases) and
equal argmax hypotheses where the top two differ by more than 1e-3, pilot
scores rtol 1e-4 / atol 1e-5 (float32 sums in another order). The
matched-filter kernels multiply in TF32 on the tensor cores; the plain
versions are float32 FFTs. A CONFIG_16 receive on the card equals the
CPU's in crc_ok, delay and decoded payloads, iters within one sweep."""

import numpy as np
import pytest
import torch

from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def geom():
    return build_geometry(0, with_pre_eq=False)


def _osc(g, n):
    ph = (2 * np.pi * g.fc / g.fs) * np.arange(n, dtype=np.float64)
    return (np.sqrt(2) * (np.cos(ph) + 1j * np.sin(ph))).astype(np.complex64)


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


@pytest.mark.cuda
def test_mix_fir_decimate_kernel_matches_plain(cuda_device, geom):
    rng = np.random.default_rng(5)
    n = 8192
    pb = torch.as_tensor(rng.standard_normal((5, n)).astype(np.float32),
                         device=cuda_device)
    osc = torch.as_tensor(_osc(geom, n), device=cuda_device)
    taps = torch.as_tensor(geom.fir_rx_data.astype(np.float32),
                           device=cuda_device)
    before = kernels.LAUNCHES["mix_fir_decimate"]
    for stride in (1, 2, 4):
        got = kernels.mix_fir_decimate(pb, osc, taps, stride)
        want = kernels.mix_fir_decimate_ref(pb, osc, taps, stride)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    start = torch.tensor([0, 17, 4000, 6000, 8300], device=cuda_device)
    got = kernels.mix_fir_decimate(pb, osc, taps, 4, start=start, n_out=700,
                                   offset=16)
    want = kernels.mix_fir_decimate_ref(pb, osc, taps, 4, start=start,
                                        n_out=700, offset=16)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert kernels.LAUNCHES["mix_fir_decimate"] == before + 4


def _direct_fir(pb, osc, taps, stride, start, n_out, offset):
    """The arithmetic of the direct per-output loop (one thread per output):
    x = p*o as two float32 products, then acc = fmaf(tap_j, x, acc) for
    j = 0..T-1, a sample outside the row skipped. Each fmaf is taken exactly
    in float64 and rounded once to float32."""
    b, n = pb.shape
    xr, xi = pb * osc.real, pb * osc.imag
    base = (start[:, None] + offset
            + torch.arange(n_out, device=pb.device)[None] * stride)
    acc = [torch.zeros((b, n_out), dtype=torch.float32, device=pb.device)
           for _ in range(2)]
    for j in range(taps.shape[0]):
        i = base - j
        inside = (i >= 0) & (i < n)
        t = taps[j].double()
        for k, x in enumerate((xr, xi)):
            v = torch.gather(x, 1, i.clamp(0, n - 1))
            acc[k] = torch.where(inside, (acc[k].double() + t * v.double())
                                 .float(), acc[k])
    return torch.complex(*acc)


# n = 9001: 2251 outputs at stride 4, 4501 at 2, 9001 at 1, none a multiple
# of the kernel's 1024-output tile
@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("batch", [1, 300])
def test_mix_fir_decimate_kernel_tiles_and_starts(cuda_device, geom, stride,
                                                  batch):
    """The tiled kernel against the plain version (atol 1e-5, rtol 1e-4) and
    bit-equal to the direct loop's arithmetic: 'same' form, and per-row
    starts before 0, inside, and past the row end."""
    rng = np.random.default_rng(stride * 1000 + batch)
    n = 9001
    pb = torch.as_tensor(rng.standard_normal((batch, n)).astype(np.float32),
                         device=cuda_device)
    osc = torch.as_tensor(_osc(geom, n), device=cuda_device)
    taps = torch.as_tensor(geom.fir_rx_data.astype(np.float32),
                           device=cuda_device)
    ntaps = taps.shape[0]
    before = kernels.LAUNCHES["mix_fir_decimate"]
    got = kernels.mix_fir_decimate(pb, osc, taps, stride)
    want = kernels.mix_fir_decimate_ref(pb, osc, taps, stride)
    assert got.shape == want.shape == (batch, (n - 1) // stride + 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    zero = torch.zeros(batch, dtype=torch.int64, device=cuda_device)
    assert torch.equal(got, _direct_fir(pb, osc, taps, stride, zero,
                                        got.shape[1], (ntaps - 1) // 2))
    start = torch.as_tensor(rng.integers(-3000, n + 500, batch),
                            device=cuda_device)
    start[0] = -40 if batch == 1 else start[0]
    if batch > 1:
        start[:3] = torch.tensor([-40, n - 100, n + 37])
    row = dict(start=start, n_out=1500, offset=ntaps - 1 - (ntaps - 1) // 2)
    got = kernels.mix_fir_decimate(pb, osc, taps, stride, **row)
    want = kernels.mix_fir_decimate_ref(pb, osc, taps, stride, **row)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert torch.equal(got, _direct_fir(pb, osc, taps, stride, **row))
    if batch > 1:
        assert (got[2] == 0).all()                 # wholly past the row
    assert kernels.LAUNCHES["mix_fir_decimate"] == before + 2


@pytest.mark.cuda
def test_deep_mf_score_kernel_matches_plain(cuda_device):
    seg, bank = _deep_case(15, 3, 4, 96, 280, 5, (2, 1, 150), silence=4)
    seg_t = torch.as_tensor(seg, device=cuda_device)
    bank_t = torch.as_tensor(bank, device=cuda_device)
    got = kernels.deep_mf_score(seg_t, bank_t, 280)
    want = kernels.deep_mf_score_ref(seg_t, bank_t, 280)
    torch.testing.assert_close(got.argmax(-1), want.argmax(-1))
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert int(got[2, 1].argmax()) == 150


@pytest.mark.cuda
def test_deep_mf_max_kernel_matches_plain(cuda_device):
    # 11 hypotheses: more than one chunk of the plain version's running max
    seg, bank = _deep_case(21, 11, 2, 64, 300, 5, (2, 9, 123), silence=3)
    seg[4, seg.shape[1] // 2:] = 0.0          # half-silent row
    seg_t = torch.as_tensor(seg, device=cuda_device)
    bank_t = torch.as_tensor(bank, device=cuda_device)
    before = kernels.LAUNCHES["deep_mf_max"]
    smax, sarg = kernels.deep_mf_max(seg_t, bank_t, 300)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deep_mf_max"] == before + 1
    ref_max, ref_arg = kernels.deep_mf_max_ref(seg_t, bank_t, 300)
    assert sarg.dtype == ref_arg.dtype == torch.int64
    torch.testing.assert_close(smax, ref_max, rtol=1e-3, atol=1e-3)
    top2 = kernels.deep_mf_score_ref(seg_t, bank_t, 300).topk(2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > 1e-3
    assert clear.float().mean() > 0.5
    assert torch.equal(sarg[clear], ref_arg[clear])
    assert int(smax[2].argmax()) == 123 and int(sarg[2, 123]) == 9


# Shapes the tensor-core tiles do not divide: 2w+1 lags ragged against the
# 256- and 128-lag tiles, 2A = 10, 122 and 140 padded to 16, 128 and 144
# columns (the last in two N chunks of 128), odd S, one part (CONFIG_0's
# layout) and four (the refine and scan layout)
RAGGED = [dict(a=5, lp=1, s=67, window=300),
          dict(a=5, lp=4, s=67, window=250),
          dict(a=61, lp=1, s=67, window=300),
          dict(a=61, lp=4, s=67, window=150),
          dict(a=70, lp=1, s=67, window=200)]
RAGGED_IDS = [f"A{c['a']}-Lp{c['lp']}" for c in RAGGED]


def _ragged_case(case, device):
    """Four rows: noise, noise with the last hypothesis planted at lag
    w + 17, noise, and an all-silent row."""
    a, lp, s, window = case["a"], case["lp"], case["s"], case["window"]
    seg, bank = _deep_case(a + lp, a, lp, s, window, 4,
                           (1, a - 1, window + 17))
    seg[3] = 0.0
    return (torch.as_tensor(seg, device=device),
            torch.as_tensor(bank, device=device))


def _clear(score, dim):
    """Where the top two of score along dim differ by more than 1e-3."""
    top2 = score.topk(2, dim=dim).values
    return top2.select(dim, 0) - top2.select(dim, 1) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED, ids=RAGGED_IDS)
def test_deep_mf_score_kernel_ragged_shapes(cuda_device, case):
    seg, bank = _ragged_case(case, cuda_device)
    a, window = case["a"], case["window"]
    before = kernels.LAUNCHES["deep_mf_score"]
    got = kernels.deep_mf_score(seg, bank, window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deep_mf_score"] == before + 1
    want = kernels.deep_mf_score_ref(seg, bank, window)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    clear = _clear(want, -1)
    assert torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    assert int(got[1, a - 1].argmax()) == window + 17
    assert (got[3] == 0).all()                      # silent row: gated


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED, ids=RAGGED_IDS)
def test_deep_mf_max_kernel_ragged_shapes(cuda_device, case):
    seg, bank = _ragged_case(case, cuda_device)
    a, window = case["a"], case["window"]
    before = kernels.LAUNCHES["deep_mf_max"]
    smax, sarg = kernels.deep_mf_max(seg, bank, window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deep_mf_max"] == before + 1
    ref_max, ref_arg = kernels.deep_mf_max_ref(seg, bank, window)
    torch.testing.assert_close(smax, ref_max, rtol=1e-3, atol=1e-3)
    clear = _clear(kernels.deep_mf_score_ref(seg, bank, window), 1)
    assert clear[:3].float().mean() > 0.5
    assert torch.equal(sarg[clear], ref_arg[clear])
    assert int(smax[1].argmax()) == window + 17
    assert int(sarg[1, window + 17]) == a - 1
    assert (smax[3] == 0).all() and (sarg[3] == 0).all()   # silent row


@pytest.mark.cuda
def test_deep_mf_max_kernel_first_hypothesis_wins_ties(cuda_device):
    """Row 7 of the bank duplicates row 3: the two score the same at every
    lag, and sarg must never read 7."""
    seg, bank = _deep_case(31, 61, 1, 67, 300, 4, (0, 3, 211))
    bank[7] = bank[3]
    seg_t = torch.as_tensor(seg, device=cuda_device)
    bank_t = torch.as_tensor(bank, device=cuda_device)
    before = kernels.LAUNCHES["deep_mf_max"]
    smax, sarg = kernels.deep_mf_max(seg_t, bank_t, 300)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deep_mf_max"] == before + 1
    ref_max, ref_arg = kernels.deep_mf_max_ref(seg_t, bank_t, 300)
    torch.testing.assert_close(smax, ref_max, rtol=1e-3, atol=1e-3)
    assert not (sarg == 7).any()
    assert int(sarg[0, 211]) == 3 and int(smax[0].argmax()) == 211
    clear = _clear(kernels.deep_mf_score_ref(seg_t, bank_t, 300), 1)
    assert torch.equal(sarg[clear], ref_arg[clear])


def _pilot_case(device):
    """Rows: stationary noise, half-silent (bursty), silent, and one 42 dB
    quieter in its second half; candidates clipped at both ends of the row
    and template rows clipped to the bank."""
    rng = np.random.default_rng(8)
    b, m, n_dec, f_n, nsym, s_d = 4, 12, 3000, 7, 6, 96
    bb = (rng.standard_normal((b, n_dec))
          + 1j * rng.standard_normal((b, n_dec))).astype(np.complex64)
    bb[1, n_dec // 2:] = 0.0
    bb[2] = 0.0
    bb[3, n_dec // 2:] *= np.float32(np.sqrt(6.6e-5))
    bank = (rng.standard_normal((f_n, nsym, s_d))
            + 1j * rng.standard_normal((f_n, nsym, s_d))).astype(np.complex64)
    idx0 = rng.integers(0, n_dec - nsym * s_d, (b, m))
    idx0[:, 0] = -50
    idx0[:, 1] = n_dec
    idx0[1, 2:6] = n_dec // 2 - np.arange(4) * 150     # across the burst edge
    fidx = rng.integers(0, f_n, (b, m))
    fidx[:, 3] = f_n + 2
    return tuple(torch.as_tensor(x, device=device)
                 for x in (bb, idx0, fidx, bank))


@pytest.mark.cuda
def test_pilot_cand_score_kernel_matches_plain(cuda_device):
    bb, idx0, fidx, bank = _pilot_case(cuda_device)
    before = kernels.LAUNCHES["pilot_cand_score"]
    got = kernels.pilot_cand_score(bb, idx0, fidx, bank)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pilot_cand_score"] == before + 1
    want = kernels.pilot_cand_score_ref(bb, idx0, fidx, bank)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert (got[2] == 0).all()                     # silent row
    assert (got[0] > 0).all()


def _pilot_general(seed, b, m, n_dec, f_n, nsym, s_d, device):
    """Rows: noise, half-silent, silent, then noise; candidates clipped at
    both row ends and template rows clipped to the bank."""
    rng = np.random.default_rng(seed)
    bb = (rng.standard_normal((b, n_dec))
          + 1j * rng.standard_normal((b, n_dec))).astype(np.complex64)
    bb[1, n_dec // 2:] = 0.0
    bb[2] = 0.0
    bank = (rng.standard_normal((f_n, nsym, s_d))
            + 1j * rng.standard_normal((f_n, nsym, s_d))).astype(np.complex64)
    idx0 = rng.integers(0, n_dec - nsym * s_d + 1, (b, m))
    idx0[:, 0] = -7
    if m > 1:
        idx0[:, 1] = n_dec + 3
    fidx = rng.integers(0, f_n, (b, m))
    fidx[:, -1] = f_n + 5
    return tuple(torch.as_tensor(x, device=device)
                 for x in (bb, idx0, fidx, bank))


# Nsym odd (the cluster's two blocks take 4 and 3 symbols, a warp's last
# symbol group is single), one symbol (the second block has none), M odd
# and above 32, S longer than a warp's stride, and CONFIG_0's M, Nsym, S
PILOT = [dict(m=5, nsym=7, s_d=67, n_dec=3000),
         dict(m=33, nsym=1, s_d=300, n_dec=2000),
         dict(m=9, nsym=5, s_d=500, n_dec=6000),
         dict(m=32, nsym=48, s_d=136, n_dec=14824)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PILOT,
                         ids=[f"M{c['m']}-N{c['nsym']}-S{c['s_d']}"
                              for c in PILOT])
def test_pilot_cand_score_kernel_shapes(cuda_device, case):
    bb, idx0, fidx, bank = _pilot_general(case["m"] + case["nsym"], 4,
                                          case["m"], case["n_dec"], 7,
                                          case["nsym"], case["s_d"],
                                          cuda_device)
    before = kernels.LAUNCHES["pilot_cand_score"]
    got = kernels.pilot_cand_score(bb, idx0, fidx, bank)
    prepared = kernels.pilot_cand_score(bb, idx0, fidx, bank,
                                        kernels.pilot_bank(bank))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pilot_cand_score"] == before + 2
    want = kernels.pilot_cand_score_ref(bb, idx0, fidx, bank)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got, prepared)
    # the rows as every other sample of a wider buffer (the receive path's
    # decimated view), read in place
    wide = torch.zeros((bb.shape[0], 2 * bb.shape[1]), dtype=bb.dtype,
                       device=cuda_device)
    wide[:, ::2] = bb
    assert torch.equal(kernels.pilot_cand_score(wide[:, ::2], idx0, fidx,
                                                bank), got)
    assert (got[2] == 0).all()                     # silent row
    assert (got[0] > 0).all() and (got[3] > 0).all()


@pytest.mark.cuda
def test_pilot_cand_score_kernel_bursty_row(cuda_device):
    """tests/test_torch_pilot.py::test_bursty_row_follows_xla_floor's row,
    decimated as sync.pilot_rescore does: seven candidates in the loud half,
    one in a half 42 dB quieter whose symbols fall under the floor of the
    energies scored, so it scores 0."""
    rng = np.random.default_rng(11)
    mf_s, ts_dec, pre_span, n_ts, m = 2, 4, 48, 6000, 8
    base = (rng.standard_normal((5, 136))
            + 1j * rng.standard_normal((5, 136))).astype(np.complex64)
    t = np.arange(136)
    bank = np.stack([base * np.exp(-1j * 2 * np.pi * f * 1e-4 * t)[None]
                     for f in range(3)]).astype(np.complex64)
    bb = (rng.standard_normal((1, n_ts))
          + 1j * rng.standard_normal((1, n_ts))).astype(np.complex64)
    bb[0, n_ts // 2:] *= np.float32(np.sqrt(6.6e-5))
    step = mf_s * ts_dec
    cand = (np.arange(m) * 40 * step - pre_span)[None].astype(np.int64)
    cand[0, -1] = (n_ts // 2 + 200) * ts_dec - pre_span
    idx0 = (cand + pre_span) // step
    args = tuple(torch.as_tensor(x, device=cuda_device) for x in (
        np.ascontiguousarray(bb[:, ::mf_s]), idx0, np.zeros((1, m), np.int64),
        bank))
    got = kernels.pilot_cand_score(*args)
    want = kernels.pilot_cand_score_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert got[0, -1] == 0.0 and (got[0, :-1] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("esn0", [31.0, 22.0])
def test_config16_receive_on_card_matches_cpu(cuda_device, esn0):
    """32QAM 14/16 (DD, BICM-ID and the MER SNR on), batch 8: clean, and
    at 22 dB where rows take a few LDPC sweeps."""
    g = build_geometry(16)
    gen = torch.Generator().manual_seed(16)
    payload = torch.randint(0, 256, (8, g.frame_bytes), generator=gen,
                            dtype=torch.uint8)
    frames = TxChain(g, device="cpu").transmit(payload)
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = sim.awgn_passband(frames, sim.sigma_for_esn0(esn0), delay,
                            g.nofdm * g.buffer_nsymb * g.interp, gen)
    before = dict(kernels.LAUNCHES)
    res = RxChain(g, device=cuda_device).receive(buf.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mix_fir_decimate"] > before["mix_fir_decimate"]
    assert kernels.LAUNCHES["deep_mf_score"] > before["deep_mf_score"]
    ref = RxChain(g, device="cpu").receive(buf)
    ok = ref.crc_ok
    assert ok.all()
    assert torch.equal(res.crc_ok.cpu(), ok)
    assert torch.equal(res.delay.cpu(), ref.delay)
    assert torch.equal(res.payload.cpu()[ok], payload[ok])
    assert (res.iters.cpu() - ref.iters).abs().max() <= 1
