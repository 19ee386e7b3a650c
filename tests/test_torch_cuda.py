"""The CUDA kernels against their plain versions, on the card (marker
`cuda`; skipped without a GPU, since a CUDA kernel has no CPU mode).

This file imports no JAX, so it runs on a machine with the card and no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Tolerances as in tests/test_torch_kernels.py: FIR atol 1e-5 / rtol 1e-4,
matched-filter scores and their max over the bank rtol/atol 1e-3 with equal
argmax lags (on every row in the first score case, on the planted rows and
wherever the top two lags differ by more than 1e-3 in the ragged cases) and
equal argmax hypotheses where the top two differ by more than 1e-3; the
best lag and score of each (row, hypothesis), deep_mf_best, bit-equal to
deep_mf_score's surface, its first argmax and the score there (the same
TF32 products summed in the same order), with no surface allocated on the
receive's refine path where the rows fill the card; pilot
scores rtol 1e-4 / atol 1e-5 (float32 sums in another order). The
layered LDPC decode as mercury_tpu_torch.tools.roofline.ldpc_agree holds
it (chip_smoke.py holds it the same way): min-sum bit-exact in bits,
iters, ok and the posterior (no transcendental; the same bf16 roundings
and additions); SPA (tanhf/atanhf and the exclusive product's order may
differ in the last ulp) ok equal on all but 1% of the rows (rounded
down), bits equal where both converged and the posterior equal in sign
where they converged at the same sweep; over at most LDPC_FEW_SWEEPS
sweeps also iters within one and the posterior within LDPC_POST_BARS'
limit and bit-equal on all but its share of the elements. Its rows stop
on their own, and roofline.ldpc_raw's launch writes only into the outputs
it holds. The
matched-filter kernels multiply in TF32 on the tensor cores; the plain
versions are float32 FFTs. A CONFIG_16 receive on the card equals the
CPU's in crc_ok, delay and decoded payloads, iters within one sweep. The
device pools (4 channels of CONFIG_16) and a two-node link session decode
every frame with their windows and chains on the card; a clean CONFIG_9
FusedDevicePool round and a CONFIG_3 round (the noncoherent scan) issue
nothing that makes the host wait on the card
(torch.cuda.set_sync_debug_mode("error")), and a CONFIG_0 round with a
blank channel makes one such call, the rescue's read of its rows, and no
copy from pageable host memory. A 2-shard virtual
mesh on the card decodes as the unsharded receive. A device span of
mercury_tpu_torch.obs times the card between its events: positive, and
no longer than the host's wall time to a synchronize after it."""

import time
import warnings

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
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("batch", [1, 300])
def test_mix_fir_decimate_kernel_row_freq(cuda_device, geom, stride, batch):
    """The per-row frequency form (offsets 0 and up to +-45 Hz) against the
    plain version (float64 phase; the kernel's float32 in-tile phase is
    within ~1e-6 rad: atol 1e-5, rtol 1e-4), 'same' form and per-row
    starts; a row at 0 Hz equals the form without offsets bit for bit."""
    rng = np.random.default_rng(stride * 7 + batch)
    n = 9001
    pb = torch.as_tensor(rng.standard_normal((batch, n)).astype(np.float32),
                         device=cuda_device)
    osc = torch.as_tensor(_osc(geom, n), device=cuda_device)
    taps = torch.as_tensor(geom.fir_rx_data.astype(np.float32),
                           device=cuda_device)
    ntaps = taps.shape[0]
    freq = torch.as_tensor(rng.uniform(-45.0, 45.0, batch).astype(np.float32),
                           device=cuda_device)
    freq[0] = 0.0
    start = torch.as_tensor(rng.integers(-3000, n + 500, batch),
                            device=cuda_device)
    before = kernels.LAUNCHES["mix_fir_decimate"]
    for row in ({}, dict(start=start, n_out=1500,
                         offset=ntaps - 1 - (ntaps - 1) // 2)):
        got = kernels.mix_fir_decimate(pb, osc, taps, stride, **row,
                                       freq=freq, fs=geom.fs)
        want = kernels.mix_fir_decimate_ref(pb, osc, taps, stride, **row,
                                            freq=freq, fs=geom.fs)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
        plain = kernels.mix_fir_decimate(pb, osc, taps, stride, **row)
        assert torch.equal(got[0], plain[0])
    assert kernels.LAUNCHES["mix_fir_decimate"] == before + 4


@pytest.mark.cuda
def test_deep_mf_score_kernel_refine_decode_shape(cuda_device):
    """refine_decode's full-rate shape at CONFIG_9: [rows, 4864] x
    [1, 4, 1088], window 256 (513 lags: two whole 256-lag tiles and one
    lag): scores rtol/atol 1e-3, argmax lag equal on every row."""
    rng = np.random.default_rng(11)
    rows, window = 24, 256
    seg, bank = _deep_case(11, 1, 4, 1088, window, rows, (0, 0, 0))
    lags = rng.integers(0, 2 * window + 1, rows)
    lags[0] = 0                         # _deep_case's plant on row 0
    for r, lag in enumerate(lags):
        seg[r, lag: lag + 4 * 1088] += 3.0 * bank[0].reshape(-1)
    seg_t = torch.as_tensor(seg, device=cuda_device)
    bank_t = torch.as_tensor(bank, device=cuda_device)
    got = kernels.deep_mf_score(seg_t, bank_t, window)
    want = kernels.deep_mf_score_ref(seg_t, bank_t, window)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got.argmax(-1)[:, 0].cpu(), torch.as_tensor(lags))


@pytest.mark.cuda
def test_decode_at_and_refine_decode_on_card_match_cpu(cuda_device):
    """CONFIG_9 frames at +20 Hz, batch 8: decode_at and refine_decode on
    the card equal the CPU's plain run in crc_ok, payload and delays."""
    g = build_geometry(9)
    gen = torch.Generator().manual_seed(9)
    payload = torch.randint(0, 256, (8, g.frame_bytes), generator=gen,
                            dtype=torch.uint8)
    frames = sim.apply_cfo(TxChain(g, device="cpu").transmit(payload), g.fs,
                           g.fc, 20.0)
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = sim.awgn_passband(frames, sim.sigma_for_esn0(14.0), delay,
                            g.nofdm * g.buffer_nsymb * g.interp, gen)
    freq = torch.full((8,), 20.0)
    outs = []
    for dev in (cuda_device, "cpu"):
        rx = RxChain(g, device=dev)
        at = rx.decode_at(buf, torch.full((8,), delay - 8), freq)
        ref = rx.refine_decode(buf, torch.full((8,), delay + 60), freq, 256)
        outs.append([t.cpu() for t in (*at[:2], *ref[:2], ref[5])])
    card, cpu = outs
    assert cpu[1].all() and cpu[3].all()
    for a, b in zip(card, cpu):
        assert torch.equal(a, b)


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


# deep_mf_best at the receive's shapes: c3's scan (rows cut), the refines
# of CONFIG_3/9 (Lp 4), 11 (3), 13 (2) and 16 (1) against the three CFO
# aliases, c2f's 5-row bank and 16 hypotheses on a 15 Hz grid
ALIASES = (0.0, 93.75, -93.75)
BEST = [dict(cfg=3, freqs=tuple(np.arange(-4, 5) * 30.0), rows=24,
             window=7140),
        dict(cfg=9, freqs=ALIASES, rows=48, window=272),
        dict(cfg=11, freqs=ALIASES, rows=48, window=272),
        dict(cfg=13, freqs=ALIASES, rows=48, window=272),
        dict(cfg=16, freqs=ALIASES, rows=48, window=272),
        dict(cfg=3, freqs=ALIASES + (15.0, -15.0), rows=48, window=272),
        dict(cfg=3, freqs=tuple(np.arange(-8, 8) * 15.0), rows=8,
             window=600)]
BEST_IDS = ["scan", "refine-CONFIG_9", "refine-CONFIG_11", "refine-CONFIG_13",
            "refine-CONFIG_16", "c2f", "16-hypotheses"]
_CHAINS = {}


def _receive_bank(cfg, freqs, device):
    """The chain's decimated preamble templates rotated to freqs, as the
    receive builds its scan and refine banks."""
    if cfg not in _CHAINS:
        _CHAINS[cfg] = RxChain(build_geometry(cfg), device=device)
    rx = _CHAINS[cfg]
    return rx._rotated_bank(rx._mf_templates[:, ::8], freqs, 8)


def _planted(bank, rows, window, seed):
    """Noise rows, each with one template of the bank at a random lag, the
    last row silent."""
    a, lp, s = bank.shape
    gen = torch.Generator(device=bank.device).manual_seed(seed)
    shape = (rows, 2 * window + lp * s)
    seg = torch.complex(torch.randn(shape, generator=gen, device=bank.device),
                        torch.randn(shape, generator=gen, device=bank.device))
    seg = 0.05 * seg
    hyp = torch.randint(0, a, (rows,), generator=gen, device=bank.device)
    lag = torch.randint(0, 2 * window + 1, (rows,), generator=gen,
                        device=bank.device)
    idx = lag[:, None] + torch.arange(lp * s, device=bank.device)[None]
    seg.scatter_add_(1, idx, bank[hyp].reshape(rows, -1))
    seg[-1] = 0
    return seg, hyp, lag


def _surface_best(seg, bank, window):
    """The surface kernel, its first argmax over the lags and the score
    there: what the receive computed before deep_mf_best."""
    score = kernels.deep_mf_score(seg, bank, window)
    lag = score.argmax(-1)
    return lag, torch.gather(score, -1, lag[..., None])[..., 0]


def _best_equal(seg, bank, window):
    """deep_mf_best's kernel (one launch, at any batch) bit-equal to
    _surface_best: the same TF32 products, summed over K and over the parts
    in the same order."""
    before = kernels.LAUNCHES["deep_mf_best"]
    lag, score = kernels.deep_mf_best_fused(seg, bank, window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deep_mf_best"] == before + 1
    want_lag, want = _surface_best(seg, bank, window)
    assert lag.dtype == torch.int64 and score.dtype == torch.float32
    assert torch.equal(lag, want_lag), int((lag != want_lag).sum())
    assert torch.equal(score, want), float((score - want).abs().max())
    return lag, score


@pytest.mark.cuda
@pytest.mark.parametrize("case", BEST, ids=BEST_IDS)
def test_deep_mf_best_kernel_matches_surface(cuda_device, case):
    bank = _receive_bank(case["cfg"], case["freqs"], cuda_device)
    seg, hyp, lag = _planted(bank, case["rows"], case["window"], 26)
    got_lag, got = _best_equal(seg, bank, case["window"])
    r = torch.arange(case["rows"] - 1, device=cuda_device)
    assert torch.equal(got_lag[r, hyp[:-1]], lag[:-1])
    # the silent row: every lag gated to 0, so the first lag wins
    assert (got_lag[-1] == 0).all() and (got[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED[:2], ids=RAGGED_IDS[:2])
def test_deep_mf_best_kernel_ragged_shapes(cuda_device, case):
    seg, bank = _ragged_case(case, cuda_device)
    lag, score = _best_equal(seg, bank, case["window"])
    assert int(lag[1, case["a"] - 1]) == case["window"] + 17
    assert (lag[3] == 0).all() and (score[3] == 0).all()    # silent row


@pytest.mark.cuda
def test_deep_mf_best_kernel_duplicated_template(cuda_device):
    """Row 5 of the scan's bank duplicates row 2: the two take the same
    best lag and score in every row."""
    bank = _receive_bank(3, tuple(np.arange(-4, 5) * 30.0), cuda_device)
    bank[5] = bank[2]
    seg, _hyp, _lag = _planted(bank, 6, 7140, 27)
    lag, score = _best_equal(seg, bank, 7140)
    assert torch.equal(lag[:, 5], lag[:, 2])
    assert torch.equal(score[:, 5], score[:, 2])


@pytest.mark.cuda
def test_refine_bank_on_card_keeps_no_surface(cuda_device, monkeypatch):
    """sync.matched_filter_refine_bank on the card takes deep_mf_best's
    kernel for the scan's 9-row bank from the rows kernels._best_rows
    names on, allocating no [B, A, 2w+1] surface, and gives the surface
    path's delays and scores; a row fewer, a 17-row bank (the "full"
    profile's grid) and refine_decode's bank (its parts add more Toeplitz
    rows than it has lags) keep deep_mf_score's surface and its argmax."""
    from mercury_tpu_torch.modem import sync
    narrow = _receive_bank(3, tuple(np.arange(-4, 5) * 30.0), cuda_device)
    wide = _receive_bank(3, tuple(np.arange(-8, 9) * 15.0), cuda_device)
    window = 7140
    rows = kernels._best_rows(cuda_device, *narrow.shape, 2 * window + 1)
    assert 1 < rows <= 1024
    seg, _hyp, _lag = _planted(narrow, rows, window, 28)
    start = torch.arange(rows, device=cuda_device)
    surface = kernels.deep_mf_score

    def peak_growth(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda_device)
        base = torch.cuda.memory_allocated(cuda_device)
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(cuda_device) - base

    (want_lag, want), surface_grew = peak_growth(
        lambda: _surface_best(seg, narrow, window))

    def no_surface(*args, **kw):
        raise AssertionError("deep_mf_score called for a narrow bank")
    monkeypatch.setattr(kernels, "deep_mf_score", no_surface)
    before = dict(kernels.LAUNCHES)
    (delay, score), grew = peak_growth(
        lambda: sync.matched_filter_refine_bank(seg, start, narrow, window))
    # the surface alone outweighs all the fused path allocates
    surface_bytes = 4 * rows * narrow.shape[0] * (2 * window + 1)
    assert grew < surface_bytes <= surface_grew
    assert kernels.LAUNCHES["deep_mf_best"] == before["deep_mf_best"] + 1
    assert torch.equal(delay, start[:, None] + want_lag)
    assert torch.equal(score, want / narrow.shape[1])
    monkeypatch.setattr(kernels, "deep_mf_score", surface)
    rd = _CHAINS[3]._mf_templates[None]
    assert kernels._best_rows(cuda_device, *rd.shape, 513) == 0
    rd_seg = 0.05 * torch.randn((4, 512 + rd.shape[1] * rd.shape[2]),
                                dtype=torch.complex64, device=cuda_device)
    for args in ((seg[:rows - 1], start[:rows - 1], narrow, window),
                 (seg[:4], start[:4], wide, window),
                 (rd_seg, start[:4], rd, 256)):
        before = dict(kernels.LAUNCHES)
        delay, score = sync.matched_filter_refine_bank(*args)
        assert kernels.LAUNCHES["deep_mf_score"] == before["deep_mf_score"] + 1
        assert kernels.LAUNCHES["deep_mf_best"] == before["deep_mf_best"]
        want_lag, _ = _surface_best(args[0], args[2], args[3])
        assert torch.equal(delay, args[1][:, None] + want_lag)


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


def _pool_streams(g, sym, buf_len, lead0, blk_syms):
    """4 channels of CONFIG_16 capture, each a frame at a lead of
    (lead0 + c) symbols in white noise, cut into blk_syms-symbol blocks."""
    rng = np.random.default_rng(3)
    payloads = rng.integers(0, 256, (4, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g, device="cpu").transmit(
        torch.from_numpy(payloads)).numpy()
    total = buf_len + 8 * sym
    streams = (2e-3 * rng.standard_normal((4, total))).astype(np.float32)
    for c in range(4):
        lead = (lead0 + c) * sym
        streams[c, lead: lead + frames.shape[1]] += frames[c]
    blk = blk_syms * sym
    return payloads, [streams[:, p: p + blk]
                      for p in range(0, total - blk + 1, blk)]


@pytest.mark.cuda
def test_device_pools_on_card_decode_every_channel(cuda_device):
    """DeviceStreamPool and FusedDevicePool of 4 channels with the windows
    on the card: every channel's frame decodes to its payload."""
    from mercury_tpu_torch.scale import serve

    g = build_geometry(16)
    rx = RxChain(g, device=cuda_device)
    pool = serve.DeviceStreamPool(g, 4, rx=rx)
    assert pool.windows.device.type == "cuda"
    payloads, blocks = _pool_streams(g, pool.sym_len, pool.buf_len, 2, 3)
    got = {}
    for block in blocks:
        pool.feed_block(block)
        for c, res in pool.step():
            got.setdefault(c, bytes(res.payload[0]))
    assert got == {c: bytes(payloads[c]) for c in range(4)}

    fused = serve.FusedDevicePool(g, 4, rx=rx)
    payloads, blocks = _pool_streams(g, fused.sym_len, fused.buf_len, 5, 6)
    got = {}
    for r, block in enumerate(blocks):
        nxt = blocks[r + 1] if r + 1 < len(blocks) else None
        packed = fused.round(block, nxt)
        assert packed.device.type == "cuda"
        for c, res in fused.unpack(packed):
            got.setdefault(c, bytes(res.payload[0]))
    assert got == {c: bytes(payloads[c]) for c in range(4)}


@pytest.mark.cuda
def test_fused_round_on_card_never_synchronizes(cuda_device):
    """A clean CONFIG_9 FusedDevicePool round of 4 channels, its next
    block's upload included, makes no call that blocks the host on the
    card: a per-round synchronize would keep the host from issuing ahead.
    The rounds before it fill the chain's caches."""
    from mercury_tpu_torch.scale import serve

    g = build_geometry(9)
    pool = serve.FusedDevicePool(g, 4, rx=RxChain(g, device=cuda_device))
    payloads, blocks = _pool_streams(g, pool.sym_len, pool.buf_len, 10, 30)
    assert len(blocks) >= 3
    for r in range(2):
        pool.unpack(pool.round(blocks[r], blocks[r + 1]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = pool.round(blocks[2], blocks[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = {c: bytes(res.payload[0]) for c, res in pool.unpack(packed)}
    assert got == {c: bytes(payloads[c]) for c in range(4)}
    assert pool.prefetched_rounds == 2


@pytest.mark.cuda
def test_config3_round_on_card_never_synchronizes(cuda_device):
    """A CONFIG_3 FusedDevicePool round of 4 channels at 6 dB (the
    noncoherent scan, its rows in the arbitration, a rate-4/16 decode),
    its next block's upload included, makes no call that blocks the host
    on the card, and delivers the bytes each channel sent. The rounds
    before it arm the pool and fill the chain's caches."""
    from mercury_tpu_torch.scale import serve

    g = build_geometry(3)
    pool = serve.FusedDevicePool(g, 4, rx=RxChain(g, device=cuda_device))
    chunk, lead = 82 * pool.sym_len, 2 * pool.sym_len
    tx = TxChain(g, device="cpu")
    rng = np.random.default_rng(7)
    sigma = sim.sigma_for_esn0(6.0)
    payloads, blocks = [], []
    for _ in range(4):
        pay = rng.integers(0, 256, (4, g.frame_bytes)).astype(np.uint8)
        frames = tx.transmit(torch.from_numpy(pay)).numpy()
        block = (sigma * rng.standard_normal((4, chunk))).astype(np.float32)
        block[:, lead: lead + frames.shape[1]] += frames
        payloads.append(pay)
        blocks.append(block)
    for r in range(2):
        pool.unpack(pool.round(blocks[r], blocks[r + 1]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = pool.round(blocks[2], blocks[3])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = {c: bytes(res.payload[0]) for c, res in pool.unpack(packed)}
    assert got == {c: bytes(payloads[2][c]) for c in range(4)}


@pytest.mark.cuda
def test_config0_round_on_card_reads_once(cuda_device):
    """A CONFIG_0 FusedDevicePool round of 4 channels at 6 dB, channel 3
    noise alone, so its CRC fails and the rescue decodes it again: under
    torch.cuda.set_sync_debug_mode("warn") the round makes exactly one
    synchronizing call (the read of the rows to decode again), a profiled
    round copies nothing from pageable host memory, and both deliver the
    bytes each of channels 0-2 sent, none on channel 3. The rounds before
    them arm the pool and fill the chain's caches."""
    from mercury_tpu_torch.scale import serve

    g = build_geometry(0)
    pool = serve.FusedDevicePool(g, 4, rx=RxChain(g, device=cuda_device))
    chunk, lead = 82 * pool.sym_len, 2 * pool.sym_len
    tx = TxChain(g, device="cpu")
    rng = np.random.default_rng(5)
    sigma = sim.sigma_for_esn0(6.0)
    payloads, blocks = [], []
    for _ in range(6):
        pay = rng.integers(0, 256, (4, g.frame_bytes)).astype(np.uint8)
        frames = tx.transmit(torch.from_numpy(pay)).numpy()
        block = (sigma * rng.standard_normal((4, chunk))).astype(np.float32)
        block[:3, lead: lead + frames.shape[1]] += frames[:3]
        payloads.append(pay)
        blocks.append(block)

    def delivered(packed, r):
        got = {c: bytes(res.payload[0]) for c, res in pool.unpack(packed)}
        assert got == {c: bytes(payloads[r][c]) for c in range(3)}

    for r in range(3):
        pool.unpack(pool.round(blocks[r], blocks[r + 1]))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            packed = pool.round(blocks[3], blocks[4])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in caught]
    delivered(packed, 3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        packed = pool.round(blocks[4], blocks[5])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any(n.startswith("Memcpy HtoD") for n in names), "no copy seen"
    assert not [n for n in names if "Pageable" in n]
    delivered(packed, 4)


@pytest.mark.cuda
def test_link_session_on_card(cuda_device):
    """A two-node CONFIG_0 session with the gearshift on at 20 dB, both
    nodes' chains on the card: every byte arrives."""
    from mercury_tpu_torch.link import protocol as P
    from mercury_tpu_torch.link.node import ArqConfig, ArqNode
    from mercury_tpu_torch.link.sim import ChannelModel, LinkSimulator

    cfg = ArqConfig(init_configuration=0, gear_shift_on=True,
                    robust_enabled=False, batch_size=3)
    cmd = ArqNode("VE3XYZ", P.COMMANDER, cfg, device=cuda_device)
    rsp = ArqNode("N0CALL", P.RESPONDER, cfg, device=cuda_device)
    assert cmd._rx.device.type == "cuda"
    link = LinkSimulator(cmd, rsp, ChannelModel(snr_db=20.0, seed=0))
    payload = bytes(np.random.default_rng(0).integers(0, 256, 600)
                    .astype(np.uint8))
    cmd.send_data(payload)
    cmd.connect("N0CALL")
    link.run(max_sim_s=1800, until=lambda: len(rsp.fifo_rx) >= len(payload))
    assert rsp.received() == payload
    assert cmd.current_configuration == rsp.current_configuration


@pytest.mark.cuda
def test_virtual_mesh_on_card(cuda_device):
    """Two shards on one card (a virtual mesh), 4 channels of CONFIG_16:
    the channel-parallel receive equals the unsharded one in its decisions,
    with each shard's chain and stream on the card and no transfer between
    shards; the time-sharded receive of a 2-slice stream claims its two
    frames, one of them completed from the halo copied on the card."""
    from mercury_tpu_torch.scale import shard

    g = build_geometry(16)
    rx = RxChain(g, device=cuda_device)
    mesh = shard.make_mesh(2, devices=[cuda_device] * 2)
    rng = np.random.default_rng(2)
    payload = rng.integers(0, 256, (4, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g, device=cuda_device).transmit(
        torch.as_tensor(payload, device=cuda_device))
    n = g.nofdm * g.buffer_nsymb * g.interp
    buf = torch.as_tensor(rng.standard_normal((4, n)).astype(np.float32),
                          device=cuda_device) * sim.sigma_for_esn0(31.0)
    buf[:, 4000: 4000 + frames.shape[1]] += frames
    run = shard.channel_parallel_receive(rx, mesh)
    res, ref = run(buf), rx.receive(buf)
    assert all(sh.rx.device.type == "cuda" and sh.stream is not None
               for sh in run.shards)
    for f in ("payload", "crc_ok", "delay", "iters"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert res.crc_ok.all() and run.log == []

    stream = 0.002 * torch.as_tensor(
        rng.standard_normal((1, 2 * n)).astype(np.float32),
        device=cuda_device)
    starts = (n - frames.shape[1] // 2, n + 12000)     # slice 0's straddles
    for k, st in enumerate(starts):
        stream[0, st: st + frames.shape[1]] += frames[k]
    ts = shard.time_sharded_receive(rx, shard.make_mesh(
        2, axis="t", devices=[cuda_device] * 2))
    out = ts(stream)
    assert out.crc_ok[:, 0].all()
    for k, st in enumerate(starts):
        assert abs(int(out.delay[k, 0]) - st) <= 16
        assert bytes(out.payload[k, 0].cpu().numpy()) == bytes(payload[k])
    assert [e["kind"] for e in ts.log if "bytes" in e] == ["halo", "dedupe"]


# ---------------------------------------------------------------------------
# the layered LDPC decode (kernels.ldpc_layered against layered_decode_ref)
# ---------------------------------------------------------------------------

LDPC_RATES = (1, 2, 3, 4, 5, 6, 8, 14)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["minsum", "spa"])
@pytest.mark.parametrize("rate", LDPC_RATES)
def test_ldpc_layered_kernel_matches_plain(cuda_device, rate, algo):
    """Batch 256 at mixed noise (rows that converge and rows that do not),
    RxChain's decoder with the posterior out, over 50 sweeps, one and
    LDPC_FEW_SWEEPS: as roofline.ldpc_agree holds them (min-sum bit-exact
    in every output; SPA element by element over few sweeps); one launch
    a decode."""
    from mercury_tpu_torch.fec import ldpc
    from mercury_tpu_torch.tools.roofline import (LDPC_FEW_SWEEPS,
                                                  ldpc_agree, ldpc_mixed_llr)

    _cw, llr = ldpc_mixed_llr(rate, 256, seed=rate)
    llr = llr.to(cuda_device)
    for max_iter in (50, 1, LDPC_FEW_SWEEPS):
        dec = ldpc.LayeredDecoder(rate, max_iter, algo=algo).to(cuda_device)
        before = kernels.LAUNCHES["ldpc_layered"]
        got = dec(llr, soft=True)
        assert kernels.LAUNCHES["ldpc_layered"] == before + 1
        want = kernels.layered_decode_ref(llr, dec.plan, max_iter, algo,
                                          dec.alpha, dec.beta, soft=True)
        torch.cuda.synchronize()
        if max_iter == 50:
            assert got[2].any() and not got[2].all()
        ldpc_agree(got, want, algo, f"rate {rate} {algo} {max_iter}",
                   max_iter)


@pytest.mark.cuda
@pytest.mark.parametrize("n_layers", [1, 4])
@pytest.mark.parametrize("rate", [1, 8, 14])
def test_ldpc_layered_kernel_grouped_layers(cuda_device, rate, n_layers):
    """Layerings below the disjoint bound (a direct call's): the kernel adds
    a variable's deltas in edge order, as the plain version does on the
    CPU (on the card its index_add_ adds them in no fixed order), so
    min-sum equals the CPU run bit for bit."""
    from mercury_tpu_torch.fec import ldpc
    from mercury_tpu_torch.tools.roofline import ldpc_mixed_llr

    _cw, llr = ldpc_mixed_llr(rate, 64, seed=10 + rate)
    dec = ldpc.LayeredDecoder(rate, algo="minsum", n_layers=n_layers)
    assert not dec.plan.disjoint
    want = dec(llr, soft=True)
    got = dec.to(cuda_device)(llr.to(cuda_device), soft=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_ldpc_layered_kernel_edges(cuda_device):
    """A clean row exits with iters 0; max_iter 0 leaves a noisy row at
    iters 1 and its input as the posterior; a cap of 5 (set_ldpc_max_iter)
    gives 6 on the rows it leaves; batch 1 (the link) and a launch on a
    side stream equal the plain version; an empty batch launches nothing."""
    from mercury_tpu_torch.fec import ldpc
    from mercury_tpu_torch.tools.roofline import ldpc_mixed_llr

    cw, llr = (t.to(cuda_device) for t in ldpc_mixed_llr(8, 8, seed=3))
    clean = 4.0 * (1 - 2 * cw).float()
    for max_iter in (0, 5, 50):
        dec = ldpc.LayeredDecoder(8, max_iter, algo="minsum").to(cuda_device)
        x = torch.cat([clean[:1], llr])
        got = dec(x, soft=True)
        want = kernels.layered_decode_ref(x, dec.plan, max_iter, "minsum",
                                          dec.alpha, soft=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert got[1][0] == 0 and got[2][0]
        assert (got[1][~got[2]] == max_iter + 1).all()
        if max_iter == 0:
            assert torch.equal(got[3], x)
    dec = ldpc.LayeredDecoder(8, algo="minsum").to(cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = dec(llr[3:4])
    torch.cuda.current_stream().wait_stream(side)
    want = kernels.layered_decode_ref(llr[3:4].cpu(), ldpc.pack_plan(8), 50,
                                      "minsum", dec.alpha)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    before = kernels.LAUNCHES["ldpc_layered"]
    bits, iters, ok = dec(llr[:0])
    assert bits.shape == (0, 1600)
    assert kernels.LAUNCHES["ldpc_layered"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["minsum", "spa"])
@pytest.mark.parametrize("rate", [1, 8, 14])
def test_ldpc_layered_kernel_rows_stop_on_their_own(cuda_device, rate, algo):
    """2049 rows (more than a wave: the rows an SM that the plans' shared
    memory allows times the SMs is at most 792 on an H100) and their first
    3 alone: a clean row, a row
    of noise that runs to the cap and a row that converges after some
    sweeps, side by side. Each row keeps its own iters and ok (0, max_iter
    + 1, between); min-sum equals the plain version in every output, SPA
    as ldpc_agree holds it; the 3-row batch gives the same bits, iters, ok
    and posterior as those rows of the large one; one launch a decode."""
    from mercury_tpu_torch.fec import ldpc
    from mercury_tpu_torch.tools.roofline import ldpc_agree, ldpc_mixed_llr

    cw, mixed = ldpc_mixed_llr(rate, 2047, seed=20 + rate)
    g = torch.Generator().manual_seed(rate)
    noise = 0.3 * torch.randn((1, mixed.shape[1]), generator=g)
    clean = 4.0 * (1 - 2 * cw[:1]).float()
    llr = torch.cat([clean, noise, mixed]).to(cuda_device)
    dec = ldpc.LayeredDecoder(rate, algo=algo).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    rows_sm = 228 * 1024 // (dec.plan.geometry.shared_bytes + 1024)
    assert rows_sm * sms < llr.shape[0]
    outs = []
    for x in (llr, llr[:3]):
        before = kernels.LAUNCHES["ldpc_layered"]
        outs.append(dec(x, soft=True))
        assert kernels.LAUNCHES["ldpc_layered"] == before + 1
    want = kernels.layered_decode_ref(llr, dec.plan, 50, algo, dec.alpha,
                                      dec.beta, soft=True)
    torch.cuda.synchronize()
    ldpc_agree(outs[0], want, algo, f"rate {rate} {algo} 2049 rows", 50)
    for a, b in zip(*outs):
        assert torch.equal(a[:3], b)
    bits, iters, ok, _post = outs[0]
    assert iters[0] == 0 and iters[1] == 51 and 0 < iters[2] <= 50
    assert ok[0] and not ok[1] and ok[2]
    assert torch.equal(bits[0], cw[0].to(cuda_device))


@pytest.mark.cuda
def test_ldpc_raw_launch_keeps_its_outputs(cuda_device):
    """roofline.ldpc_raw's launch writes into outputs that live as long as
    it does: tensors of the outputs' sizes allocated after it was built
    (where the caching allocator would hand back freed outputs) are left
    as they were by its launches."""
    from mercury_tpu_torch.fec import ldpc
    from mercury_tpu_torch.tools.roofline import ldpc_mixed_llr, ldpc_raw

    _cw, llr = ldpc_mixed_llr(8, 64, seed=24)
    llr = llr.to(cuda_device)
    dec = ldpc.LayeredDecoder(8).to(cuda_device)
    launch = ldpc_raw(llr, dec.plan, 50, soft=True)
    b, n = llr.shape
    later = (torch.full((b, n), 7, dtype=torch.int64, device=cuda_device),
             torch.full((b,), -1, dtype=torch.int64, device=cuda_device),
             torch.zeros((b,), dtype=torch.bool, device=cuda_device),
             torch.full((b, n), float("nan"), device=cuda_device))
    for _ in range(3):
        assert launch() == 0
    torch.cuda.synchronize()
    assert dec(llr)[2].any()          # some rows converge: ok is written
    assert (later[0] == 7).all() and (later[1] == -1).all()
    assert not later[2].any() and later[3].isnan().all()


@pytest.mark.cuda
def test_device_span_times_the_card(cuda_device):
    """A device span's ms, from its start event to its end event on the
    current device's current stream, is positive and no longer than the host's wall time
    from the span's start to a synchronize after it."""
    from mercury_tpu_torch import obs

    x = torch.randn(4096, 4096, device=cuda_device)
    torch.cuda.synchronize()
    obs.clear()
    try:
        with obs.recording():
            with obs.span("matmul", 1, device=True):
                y = x @ x
                y = y @ x
            torch.cuda.synchronize()
            done = time.perf_counter_ns()
        s = obs.spans()
        assert [str(n) for n in s["name"]] == ["matmul"]
        wall_ms = (done - int(s["start_ns"][0])) / 1e6
        assert 0 < s["device_ms"][0] <= wall_ms
    finally:
        obs.clear()
