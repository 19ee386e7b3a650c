"""The receive path's four hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel (built at first use by `native.load_library`)
or raises; there is no fallback. `LAUNCHES` counts kernel launches, one per
wrapper call that reaches the card.
"""

from __future__ import annotations

import math

import torch

from mercury_tpu_torch import native
from mercury_tpu_torch.dsp import ops

LAUNCHES = {"mix_fir_decimate": 0, "deep_mf_score": 0, "deep_mf_max": 0,
            "pilot_cand_score": 0}
# hypotheses per FFT pass of deep_mf_max_ref: bounds its [B, A, 2w+1] surface
_MAX_CHUNK = 8


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# Fused mixer + decimating FIR
# ---------------------------------------------------------------------------

def row_rotation(freq: torch.Tensor, fs: float,
                 idx: torch.Tensor) -> torch.Tensor:
    """e^{j 2 pi freq[b] idx / fs} as complex64: freq [B] Hz, idx [B, L] (or
    [L]) sample indices; the phase in float64, reduced mod 2 pi before the
    rounding."""
    w = freq.to(torch.float64) * (2.0 * math.pi / fs)
    ph = torch.remainder(w[:, None] * idx.to(torch.float64), 2.0 * math.pi)
    return torch.polar(torch.ones_like(ph), ph).to(torch.complex64)


def mix_fir_decimate_ref(pb: torch.Tensor, osc: torch.Tensor,
                         taps: torch.Tensor, stride: int,
                         start: torch.Tensor | None = None,
                         n_out: int | None = None,
                         offset: int | None = None,
                         freq: torch.Tensor | None = None,
                         fs: float | None = None) -> torch.Tensor:
    """Plain version: mix with the oscillator table, then the strided 'same'
    FIR (start None) or the segment FIR at per-row starts.

    pb [B, n] real; osc [n] complex; taps [T] real. start None gives
    fir_same(pb*osc)[:, ::stride]. With a start [B] (and n_out, offset),
    out[b, m] = sum_j taps[j] * x[b, start[b] + m*stride + offset - j] for
    m < n_out, x = pb*osc zero outside [0, n). With freq [B] (Hz, at sample
    rate fs) row b mixes with osc[i] * e^{j 2 pi freq[b] i / fs} instead of
    osc[i] (row_rotation)."""
    n = pb.shape[-1]
    if start is None:
        if freq is None:
            x = pb * osc
        else:
            rot = row_rotation(freq, fs, torch.arange(n, device=pb.device))
            x = pb * (osc * rot)
        return ops.fir_same_strided(x, taps, stride)
    ntaps = taps.shape[0]
    seg_len = n_out * stride + ntaps - 1
    lo = offset - (ntaps - 1)                    # seg[k] = x[start + lo + k]
    idx = (start + lo)[:, None] + torch.arange(seg_len, device=pb.device)
    inside = (idx >= 0) & (idx < n)
    at = torch.clamp(idx, 0, n - 1)
    o = osc[at]
    if freq is not None:
        o = o * row_rotation(freq, fs, idx)
    seg = torch.where(inside, torch.gather(pb, 1, at) * o, 0)
    return ops.fir_decimate_segment(seg, taps, stride)


def mix_fir_decimate(pb: torch.Tensor, osc: torch.Tensor, taps: torch.Tensor,
                     stride: int, start: torch.Tensor | None = None,
                     n_out: int | None = None,
                     offset: int | None = None,
                     freq: torch.Tensor | None = None,
                     fs: float | None = None) -> torch.Tensor:
    """Real passband [B, n] -> complex baseband [B, n_out]: mixer and
    decimating FIR in one pass (see mix_fir_decimate_ref for the function).

    CUDA: float32 pb, complex64 osc, float32 taps, int64 start, float32 freq
    (with fs), all on one device; output complex64. A block per tile of 512
    outputs of one row (of two rows for the "same" form without offsets,
    which share the oscillator) mixes the tile's input window once into
    shared memory and filters it from there; a per-row offset turns each
    sample's oscillator value by the row's rotation (its phase in float64
    from freq and fs, in the kernel) as it is staged."""
    if pb.device.type == "cpu":
        return mix_fir_decimate_ref(pb, osc, taps, stride, start, n_out,
                                    offset, freq, fs)
    _require(pb.device.type == "cuda", f"unsupported device {pb.device}")
    b, n = pb.shape
    ntaps = taps.shape[0]
    operands = [(pb, torch.float32, (b, n)), (osc, torch.complex64, (n,)),
                (taps, torch.float32, (ntaps,))]
    if start is None:                      # "same" alignment from sample 0
        n_out, offset = (n - 1) // stride + 1, (ntaps - 1) // 2
    elif n_out is None or offset is None:
        raise ValueError("a per-row start needs n_out and offset")
    else:
        operands.append((start, torch.int64, (b,)))
    if freq is not None:
        _require(fs is not None and fs > 0,
                 "a per-row frequency offset needs fs")
        operands.append((freq, torch.float32, (b,)))
    for t, dt, shape in operands:
        _require(t.device == pb.device and t.dtype == dt
                 and tuple(t.shape) == shape and t.is_contiguous(),
                 f"mix_fir_decimate: expected contiguous {dt} {shape} on "
                 f"{pb.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((b, n_out), dtype=torch.complex64, device=pb.device)
    lib = native.load_library()
    # a NULL start: every row starts at 0, and rows share oscillator reads
    err = lib.mfd_launch(pb.data_ptr(), osc.data_ptr(), taps.data_ptr(),
                         None if start is None else start.data_ptr(),
                         None if freq is None else freq.data_ptr(),
                         0.0 if freq is None else float(fs),
                         out.data_ptr(), b, n, n_out, stride, offset, ntaps,
                         _stream(pb))
    _check(err, "mix_fir_decimate")
    LAUNCHES["mix_fir_decimate"] += 1
    return out


# ---------------------------------------------------------------------------
# Matched-filter bank scores
# ---------------------------------------------------------------------------

def _energy_terms(seg: torch.Tensor, s: int):
    """Prefix sums of |seg|^2 (cumsum, then difference at the use site, as
    the JAX scoring does) and the per-row silence floor."""
    e = torch.abs(seg) ** 2
    ce = torch.cat([torch.zeros_like(e[:, :1]), torch.cumsum(e, dim=-1)],
                   dim=-1)
    e_floor = 1e-4 * torch.mean(e, dim=-1, keepdim=True) * s + 1e-20
    return ce, e_floor


def deep_mf_score_ref(seg: torch.Tensor, bank: torch.Tensor, window: int,
                      nfft: int | None = None) -> torch.Tensor:
    """Plain version (FFT correlation, mercury_tpu sync.bank_scores):
    seg [B, L] complex, bank [A, Lp, S] complex -> score [B, A, 2w+1]
    before the final /Lp. `nfft` is ignored: the transform is the next
    power of two >= L, as in the JAX scoring."""
    b, seg_len = seg.shape
    a, lp, s = bank.shape
    n_cand = 2 * window + 1
    n2 = 1
    while n2 < seg_len:
        n2 *= 2
    # template spectra in double precision, rounded to the working type
    tfc = torch.conj(torch.fft.fft(bank.to(torch.complex128), n=n2,
                                   dim=-1)).to(seg.dtype)
    xf = torch.fft.fft(seg, n=n2, dim=-1)
    ce, e_floor = _energy_terms(seg, s)
    t_norm = torch.sqrt(torch.sum(torch.abs(bank) ** 2, dim=-1))   # [A, Lp]
    score = torch.zeros((b, a, n_cand), dtype=seg.real.dtype,
                        device=seg.device)
    for l in range(lp):
        corr = torch.fft.ifft(xf[:, None, :] * tfc[None, :, l, :], dim=-1)
        c_l = torch.abs(corr[..., l * s: l * s + n_cand])           # [B, A, nc]
        e_l = ce[:, l * s + s: l * s + s + n_cand] - ce[:, l * s: l * s + n_cand]
        term = c_l / (torch.sqrt(torch.maximum(e_l, e_floor))[:, None]
                      * t_norm[None, :, l, None])
        score = score + torch.where(e_l[:, None] > e_floor[:, None], term, 0.0)
    return score


def _dmf_pack_pairs(bank: torch.Tensor) -> torch.Tensor:
    """dmf_pack_bank's matrix as [Lp, S, N, 2]: element [l, k, n, r] is row
    2k + r, column n. Columns 2a and 2a+1 of row pair k are the complex
    pairs t and i*t: (tr, ti) and (-ti, tr)."""
    a, lp, s = bank.shape
    t = bank / torch.linalg.vector_norm(bank, dim=-1, keepdim=True)
    t = t.permute(1, 2, 0)                                   # [Lp, S, A]
    pairs = torch.view_as_real(torch.stack((t, t * 1j), dim=-1))
    n = -(-2 * a // 8) * 8
    return torch.nn.functional.pad(pairs.reshape(lp, s, 2 * a, 2),
                                   (0, 0, 0, n - 2 * a))


def dmf_pack_bank(bank: torch.Tensor) -> torch.Tensor:
    """The matched-filter GEMM's B operand: bank [A, Lp, S] complex ->
    real [Lp, 2S, N] float32, N = 2A rounded up to a multiple of 8, the
    padded columns zero.

    Templates are normalized per (a, l) and conjugated. Row 2k takes the
    real and row 2k+1 the imaginary part of window sample k; column 2a
    gives Re and column 2a+1 Im of the correlation with template a:
    B[2k, 2a] = tr, B[2k+1, 2a] = ti, B[2k, 2a+1] = -ti, B[2k+1, 2a+1] = tr.
    So with the Toeplitz window X[d, 2k + r] = (Re, Im)[r] of
    seg[d + l*S + k], (X @ B[l])[d, 2a : 2a+2] is
    sum_k seg[d + l*S + k] * conj(t[a, l, k]) as (Re, Im)."""
    pairs = _dmf_pack_pairs(bank)
    lp, s, n, _ = pairs.shape
    return pairs.transpose(2, 3).reshape(lp, 2 * s, n)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: what cvt.rna.tf32.f32 gives for finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _dmf_kernel_bank(bank: torch.Tensor) -> torch.Tensor:
    """The bank as the kernels read it: dmf_pack_bank's [Lp, 2S, N] in
    wgmma's K-major 8 x 4 core matrices, [Lp, ceil(S/4), N/8, 2, 8, 4], in
    TF32. Element [l, k4, G, h, row, j] is row 2(4*k4 + j) + h, column
    8G + row (zero past S): one k8 step of 8 columns is two 128-byte core
    matrices, the real rows of four samples and then their imaginary rows."""
    pairs = _dmf_pack_pairs(bank)                            # [Lp, S, N, 2]
    lp, s, n, _ = pairs.shape
    s4 = -(-s // 4)
    if s4 * 4 > s:
        pairs = torch.nn.functional.pad(pairs, (0, 0, 0, 0, 0, 4 * s4 - s))
    return _tf32(pairs.reshape(lp, s4, 4, n // 8, 8, 2)
                 .permute(0, 1, 3, 5, 4, 2))


def _dmf_operands(seg: torch.Tensor, bank: torch.Tensor, window: int,
                  name: str):
    """Checks and kernel operands shared by deep_mf_score and deep_mf_max:
    (seg, _dmf_kernel_bank, energy prefix sums, floor)."""
    _require(seg.device.type == "cuda", f"unsupported device {seg.device}")
    _, seg_len = seg.shape
    _, lp, s = bank.shape
    _require(seg.dtype == torch.complex64 and bank.dtype == torch.complex64,
             f"{name}: complex64 seg and bank required")
    _require(bank.device == seg.device, f"{name}: bank on another device")
    _require(seg_len >= 2 * window + lp * s,
             f"{name}: segment {seg_len} shorter than 2*{window} + {lp}*{s}")
    seg = seg.contiguous()
    # the packed, normalized bank and the energy prefix sums stay in torch,
    # as the JAX wrapper keeps t_norm outside its pallas_call
    tmpl = _dmf_kernel_bank(bank)
    ce, e_floor = _energy_terms(seg, s)
    return seg, tmpl, ce, e_floor.reshape(-1)


def deep_mf_score(seg: torch.Tensor, bank: torch.Tensor, window: int,
                  nfft: int | None = None) -> torch.Tensor:
    """Normalized matched-filter scores of bank [A, Lp, S] against seg
    [B, L] at lags 0..2*window -> [B, A, 2*window+1] float32 (before /Lp).

    CUDA: the time-domain correlation as a Toeplitz GEMM on the tensor
    cores (TF32) in one kernel; `nfft` is accepted for the JAX signature and
    not needed. Requires L >= 2*window + Lp*S."""
    if seg.device.type == "cpu":
        return deep_mf_score_ref(seg, bank, window, nfft)
    seg, tmpl, ce, ef = _dmf_operands(seg, bank, window, "deep_mf_score")
    b, seg_len = seg.shape
    a, lp, s = bank.shape
    n_cand = 2 * window + 1
    out = torch.empty((b, a, n_cand), dtype=torch.float32, device=seg.device)
    lib = native.load_library()
    err = lib.dmf_launch(seg.data_ptr(), tmpl.data_ptr(), ce.data_ptr(),
                         ef.data_ptr(), out.data_ptr(), b, a, seg_len, lp, s,
                         n_cand, 8 * tmpl.shape[2], _stream(seg))
    _check(err, "deep_mf_score")
    LAUNCHES["deep_mf_score"] += 1
    return out


# ---------------------------------------------------------------------------
# Matched-filter scores max-reduced over the bank
# ---------------------------------------------------------------------------

def deep_mf_max_ref(seg: torch.Tensor, bank: torch.Tensor, window: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: deep_mf_score_ref reduced over the hypothesis axis,
    (max [B, 2w+1], first argmax [B, 2w+1] int64), as mercury_tpu
    sync.coherent_scan_max computes it off the TPU. The bank goes through
    in chunks with a running max (strict >, so the first hypothesis wins a
    tie), which bounds the score surface held at once."""
    smax = sarg = None
    for a0 in range(0, bank.shape[0], _MAX_CHUNK):
        score = deep_mf_score_ref(seg, bank[a0: a0 + _MAX_CHUNK], window)
        c_max = torch.amax(score, dim=1)
        c_arg = torch.argmax(score, dim=1) + a0
        if smax is None:
            smax, sarg = c_max, c_arg
        else:
            better = c_max > smax
            smax = torch.where(better, c_max, smax)
            sarg = torch.where(better, c_arg, sarg)
    return smax, sarg


def deep_mf_max(seg: torch.Tensor, bank: torch.Tensor, window: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """deep_mf_score of bank [A, Lp, S] against seg [B, L], reduced over A
    -> (smax [B, 2w+1] float32, sarg [B, 2w+1] int64, the first a reaching
    the max). CUDA: one kernel holds every hypothesis of a lag tile in the
    N dimension of its GEMM and reduces over them in registers, so the
    [B, A, 2w+1] surface never reaches device memory."""
    if seg.device.type == "cpu":
        return deep_mf_max_ref(seg, bank, window)
    seg, tmpl, ce, ef = _dmf_operands(seg, bank, window, "deep_mf_max")
    b, seg_len = seg.shape
    a, lp, s = bank.shape
    n_cand = 2 * window + 1
    smax = torch.empty((b, n_cand), dtype=torch.float32, device=seg.device)
    sarg = torch.empty((b, n_cand), dtype=torch.int64, device=seg.device)
    lib = native.load_library()
    err = lib.dmf_max_launch(seg.data_ptr(), tmpl.data_ptr(), ce.data_ptr(),
                             ef.data_ptr(), smax.data_ptr(), sarg.data_ptr(),
                             b, a, seg_len, lp, s, n_cand, 8 * tmpl.shape[2],
                             _stream(seg))
    _check(err, "deep_mf_max")
    LAUNCHES["deep_mf_max"] += 1
    return smax, sarg


# ---------------------------------------------------------------------------
# Pilot-lattice candidate scores
# ---------------------------------------------------------------------------

def _clip_candidates(n_dec: int, idx0: torch.Tensor, fidx: torch.Tensor,
                     bank: torch.Tensor):
    """Starts clipped so every segment lies inside the row, template rows
    clipped to the bank (as the TPU kernel clips them)."""
    f_n, nsym, s_d = bank.shape
    _require(n_dec >= nsym * s_d,
             f"pilot_cand_score: row of {n_dec} shorter than the "
             f"{nsym}x{s_d} template")
    return (torch.clamp(idx0.long(), 0, n_dec - nsym * s_d),
            torch.clamp(fidx.long(), 0, f_n - 1))


def pilot_energy(bank: torch.Tensor) -> torch.Tensor:
    """Energy of each template symbol of bank row 0 [Nsym] float32, the
    normalization of pilot_cand_score."""
    return torch.sum(torch.abs(bank[0]) ** 2, dim=-1)


def pilot_bank(bank: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bank [F, Nsym, S_d] as the pilot_cand_score kernel reads it:
    transposed to [F, S_d, Nsym] (a thread per symbol, neighbouring threads
    on neighbouring symbols), and its pilot_energy. A chain prepares both
    once per bank and passes them to every call."""
    return bank.transpose(1, 2).contiguous(), pilot_energy(bank)


def pilot_cand_score_ref(bb_dec: torch.Tensor, idx0: torch.Tensor,
                         fidx: torch.Tensor, bank: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version, the XLA body of mercury_tpu sync.pilot_rescore
    (sync.py:467-481): per row b and candidate m, the segment of bb_dec
    [B, n_dec] at idx0[b, m] (Nsym symbols of S_d samples) against template
    row fidx[b, m] of bank [F, Nsym, S_d], coherent within each symbol and
    summed in magnitude over symbols whose energy clears the row's silence
    floor, 1e-4 x the mean energy of the segments scored -> [B, M]."""
    b, n_dec = bb_dec.shape
    m = idx0.shape[1]
    _, nsym, s_d = bank.shape
    idx0, fidx = _clip_candidates(n_dec, idx0, fidx, bank)
    pos = idx0[..., None] + torch.arange(nsym * s_d, device=bb_dec.device)
    seg = torch.gather(bb_dec, 1, pos.reshape(b, -1)).reshape(b, m, nsym, s_d)
    bk = torch.conj_physical(bank)[fidx]               # [B, M, Nsym, S_d]
    c = torch.sum(seg * bk, dim=-1)                    # [B, M, Nsym]
    e_s = torch.sum(seg.real ** 2 + seg.imag ** 2, dim=-1)
    e_t = pilot_energy(bank)                           # [Nsym]
    e_floor = 1e-4 * torch.mean(e_s, dim=(-2, -1), keepdim=True) + 1e-20
    term = torch.abs(c) / torch.sqrt(torch.clamp(e_s * e_t, min=1e-30))
    return torch.sum(torch.where(e_s > e_floor, term, 0.0), dim=-1)


def pilot_cand_score(bb_dec: torch.Tensor, idx0: torch.Tensor,
                     fidx: torch.Tensor, bank: torch.Tensor,
                     prepared: tuple[torch.Tensor, torch.Tensor] | None = None
                     ) -> torch.Tensor:
    """Pilot-lattice scores [B, M] of candidate starts idx0 [B, M] (into
    bb_dec [B, n_dec]) at template rows fidx [B, M] of bank [F, Nsym, S_d]
    (see pilot_cand_score_ref). prepared is pilot_bank(bank), computed here
    when not given. CUDA: one kernel, a cluster of two blocks per row, a
    thread per (candidate, symbol). It clips the starts and template rows
    itself, conjugates the bank as it reads it, and takes bb_dec as a
    strided view (the receive path's decimated baseband) without a copy."""
    if bb_dec.device.type == "cpu":
        return pilot_cand_score_ref(bb_dec, idx0, fidx, bank)
    _require(bb_dec.device.type == "cuda",
             f"unsupported device {bb_dec.device}")
    b, n_dec = bb_dec.shape
    m = idx0.shape[1]
    f_n, nsym, s_d = bank.shape
    bank_t, e_t = pilot_bank(bank) if prepared is None else prepared
    _require(bb_dec.dtype == torch.complex64
             and bank_t.dtype == torch.complex64
             and e_t.dtype == torch.float32,
             "pilot_cand_score: complex64 baseband and bank, float32 "
             "energies required")
    _require(all(t.device == bb_dec.device
                 for t in (idx0, fidx, bank_t, e_t)),
             "pilot_cand_score: operands on different devices")
    _require(tuple(idx0.shape) == tuple(fidx.shape) == (b, m),
             f"pilot_cand_score: idx0 {tuple(idx0.shape)} and fidx "
             f"{tuple(fidx.shape)} must both be ({b}, M)")
    _require(tuple(bank_t.shape) == (f_n, s_d, nsym)
             and tuple(e_t.shape) == (nsym,),
             f"pilot_cand_score: prepared bank {tuple(bank_t.shape)} and "
             f"energies {tuple(e_t.shape)} do not match the bank "
             f"{tuple(bank.shape)}")
    _require(n_dec >= nsym * s_d,
             f"pilot_cand_score: row of {n_dec} shorter than the "
             f"{nsym}x{s_d} template")
    if bb_dec.stride(-1) < 1:
        bb_dec = bb_dec.contiguous()
    idx0, fidx, bank_t, e_t = (t.contiguous() for t in
                               (idx0.long(), fidx.long(), bank_t, e_t))
    out = torch.empty((b, m), dtype=torch.float32, device=bb_dec.device)
    lib = native.load_library()
    err = lib.pcs_launch(bb_dec.data_ptr(), idx0.data_ptr(), fidx.data_ptr(),
                         bank_t.data_ptr(), e_t.data_ptr(), out.data_ptr(),
                         b, n_dec, bb_dec.stride(0), bb_dec.stride(1), m,
                         f_n, nsym, s_d, _stream(bb_dec))
    _check(err, "pilot_cand_score")
    LAUNCHES["pilot_cand_score"] += 1
    return out
