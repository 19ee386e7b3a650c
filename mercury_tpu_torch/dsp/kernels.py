"""The receive path's hand-written CUDA kernels, each beside its plain
PyTorch version: the mixer and decimating FIR, the matched-filter bank
scores, their max over the bank and their best lag for each hypothesis, the
pilot candidate scores, and the layered LDPC decode.

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel (built at first use by `native.load_library`)
or raises; there is no fallback. `LAUNCHES` counts kernel launches, one per
wrapper call that reaches the card; the counts and each launch are safe
to call from several threads, and a launch runs on its operands' card
whatever device the calling thread has current.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import ClassVar

import numpy as np
import torch

from mercury_tpu_torch import native
from mercury_tpu_torch.dsp import ops

LAUNCHES = {"mix_fir_decimate": 0, "deep_mf_score": 0, "deep_mf_max": 0,
            "deep_mf_best": 0, "pilot_cand_score": 0, "ldpc_layered": 0}
_LAUNCHES_LOCK = threading.Lock()
# hypotheses per FFT pass of deep_mf_max_ref: bounds its [B, A, 2w+1] surface
_MAX_CHUNK = 8


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _launch(name: str, t: torch.Tensor, entry, *args) -> None:
    """Call the C entry point `entry` with the current stream of t's card
    appended, under that card as the current device (cudaFuncSetAttribute
    and the launch act on the thread's current device); raise on an error,
    else count the launch."""
    with torch.cuda.device(t.device):
        err = entry(*args, _stream(t))
    _check(err, name)
    _count(name)


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


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
    """e^{j 2 pi freq[b] idx / fs} as complex64 (complex128 for a float64
    freq): freq [B] Hz, idx [B, L] (or [L]) sample indices; the phase in
    float64, reduced mod 2 pi before the rounding."""
    w = freq.to(torch.float64) * (2.0 * math.pi / fs)
    ph = torch.remainder(w[:, None] * idx.to(torch.float64), 2.0 * math.pi)
    rot = torch.polar(torch.ones_like(ph), ph)
    return rot if freq.dtype == torch.float64 else rot.to(torch.complex64)


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
    # a NULL start: every row starts at 0, and rows share oscillator reads
    _launch("mix_fir_decimate", pb, native.load_library().mfd_launch,
            pb.data_ptr(), osc.data_ptr(), taps.data_ptr(),
            None if start is None else start.data_ptr(),
            None if freq is None else freq.data_ptr(),
            0.0 if freq is None else float(fs),
            out.data_ptr(), b, n, n_out, stride, offset, ntaps)
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
    return _core_matrices(_dmf_pack_pairs(bank))


def _dmf_best_bank(bank: torch.Tensor) -> torch.Tensor:
    """The bank as deep_mf_best's kernel reads it: the parts side by side
    in one matrix, column l*2A + 2a + r (r: Re, Im) of part l, hypothesis
    a, padded to a multiple of 8 columns, in _core_matrices' layout
    [ceil(S/4), N/8, 2, 8, 4]: the same TF32 values as _dmf_kernel_bank's."""
    a, lp, s = bank.shape
    pairs = _dmf_pack_pairs(bank)[:, :, :2 * a]             # [Lp, S, 2A, 2]
    pairs = pairs.transpose(0, 1).reshape(1, s, 2 * lp * a, 2)
    n = -(-2 * lp * a // 8) * 8
    pairs = torch.nn.functional.pad(pairs, (0, 0, 0, n - 2 * lp * a))
    return _core_matrices(pairs)[0]


def _core_matrices(pairs: torch.Tensor) -> torch.Tensor:
    """pairs [Lp, S, N, 2] (element [l, k, n, r] is row 2k + r, column n)
    as wgmma's K-major core matrices [Lp, ceil(S/4), N/8, 2, 8, 4], TF32."""
    lp, s, n, _ = pairs.shape
    s4 = -(-s // 4)
    if s4 * 4 > s:
        pairs = torch.nn.functional.pad(pairs, (0, 0, 0, 0, 0, 4 * s4 - s))
    return _tf32(pairs.reshape(lp, s4, 4, n // 8, 8, 2)
                 .permute(0, 1, 3, 5, 4, 2))


def _dmf_operands(seg: torch.Tensor, bank: torch.Tensor, window: int,
                  name: str, pack=_dmf_kernel_bank):
    """Checks and kernel operands shared by the matched-filter kernels:
    (seg, the bank packed by `pack`, energy prefix sums, floor)."""
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
    tmpl = pack(bank)
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
    _launch("deep_mf_score", seg, native.load_library().dmf_launch,
            seg.data_ptr(), tmpl.data_ptr(), ce.data_ptr(), ef.data_ptr(),
            out.data_ptr(), b, a, seg_len, lp, s, n_cand, 8 * tmpl.shape[2])
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
    _launch("deep_mf_max", seg, native.load_library().dmf_max_launch,
            seg.data_ptr(), tmpl.data_ptr(), ce.data_ptr(), ef.data_ptr(),
            smax.data_ptr(), sarg.data_ptr(), b, a, seg_len, lp, s, n_cand,
            8 * tmpl.shape[2])
    return smax, sarg


# ---------------------------------------------------------------------------
# The best lag of each hypothesis
# ---------------------------------------------------------------------------

def deep_mf_best_ref(seg: torch.Tensor, bank: torch.Tensor, window: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: deep_mf_score_ref, its first argmax over the lags and
    the score there -> (lag [B, A] int64, score [B, A] float32)."""
    score = deep_mf_score_ref(seg, bank, window)
    lag = torch.argmax(score, dim=-1)
    return lag, torch.gather(score, -1, lag[..., None])[..., 0]


@functools.lru_cache(maxsize=None)
def _best_rows(device: torch.device, a: int, lp: int, s: int,
               n_cand: int) -> int:
    """The fewest rows at which deep_mf_best takes its kernel for a bank
    [A, Lp, S] at n_cand lags on `device`, 0 where it never does (the
    rule is the kernel file's dmf_best_rows)."""
    with torch.cuda.device(device):
        return int(native.load_library().dmf_best_rows(a, lp, s, n_cand))


def deep_mf_best(seg: torch.Tensor, bank: torch.Tensor, window: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """deep_mf_score of bank [A, Lp, S] against seg [B, L] reduced over the
    lags -> (lag [B, A] int64, the first lag reaching the best score;
    score [B, A] float32, before /Lp). On the card, where the rows fill it
    and the bank suits the kernel (at most 16 hypotheses; _best_rows),
    deep_mf_best_fused's one launch, without the [B, A, 2w+1] surface;
    else, and on the CPU, deep_mf_score's surface, its argmax and the
    score there."""
    if seg.device.type == "cuda":
        rows = _best_rows(seg.device, *bank.shape, 2 * window + 1)
        if rows and seg.shape[0] >= rows:
            return deep_mf_best_fused(seg, bank, window)
    score = deep_mf_score(seg, bank, window)
    lag = torch.argmax(score, dim=-1)
    return lag, torch.gather(score, -1, lag[..., None])[..., 0]


def deep_mf_best_fused(seg: torch.Tensor, bank: torch.Tensor, window: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """deep_mf_best's kernel at any batch (CUDA only; a bank of at most 16
    hypotheses whose tiles fit the card's shared memory): a block of
    workers around the bank resident in shared memory, each walking a whole
    row, multiplies every part's columns in one GEMM over the segment's
    Toeplitz rows, sums each lag's parts in shared memory in order of the
    part (deep_mf_score's sums, bit for bit) and keeps the running best, so
    the surface never reaches device memory. -> deep_mf_best's outputs."""
    seg, tmpl, ce, ef = _dmf_operands(seg, bank, window, "deep_mf_best",
                                      _dmf_best_bank)
    b, seg_len = seg.shape
    a, lp, s = bank.shape
    score = torch.empty((b, a), dtype=torch.float32, device=seg.device)
    lag = torch.empty((b, a), dtype=torch.int64, device=seg.device)
    _launch("deep_mf_best", seg, native.load_library().dmf_best_launch,
            seg.data_ptr(), tmpl.data_ptr(), ce.data_ptr(), ef.data_ptr(),
            score.data_ptr(), lag.data_ptr(), b, a, seg_len, lp, s,
            2 * window + 1)
    return lag, score


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
    _launch("pilot_cand_score", bb_dec, native.load_library().pcs_launch,
            bb_dec.data_ptr(), idx0.data_ptr(), fidx.data_ptr(),
            bank_t.data_ptr(), e_t.data_ptr(), out.data_ptr(), b, n_dec,
            bb_dec.stride(0), bb_dec.stride(1), m, f_n, nsym, s_d)
    return out


# ---------------------------------------------------------------------------
# Layered LDPC decode
# ---------------------------------------------------------------------------

_BIG = 3.0e38
# edges one lane holds of a check at most (csrc/ldpc_layered.cu's kernels
# take 1 and 2)
_LDPC_KMAX = 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def check_node_update(q: torch.Tensor, mask: torch.Tensor, algo: str = "spa",
                      alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """Check update on edge messages q [B, P, Cw] (mask [P, Cw]); 0 on
    padded edges.

    "spa": R = 2 atanh(prod_{other edges} tanh(q/2)), exclusive products
    from forward/backward cumulative products. "minsum": offset min-sum,
    R = sign_excl * clip(alpha * max(min_excl - beta, 0), 0, 8.7), the
    exclusive minimum from (min1, min2, first occurrence of min1) and the
    exclusive sign from the parity of the negative edges."""
    if algo == "minsum":
        absq = torch.where(mask, torch.abs(q), _BIG)
        min1 = torch.amin(absq, dim=-1, keepdim=True)
        eq = absq == min1
        is_min = eq & (torch.cumsum(eq.to(torch.int32), dim=-1) == 1)
        min2 = torch.amin(torch.where(is_min, _BIG, absq), dim=-1,
                          keepdim=True)
        excl_min = torch.where(is_min, min2, min1)
        # the clip to the SPA's effective atanh bound keeps messages from
        # growing without bound through the graph's cycles
        excl_min = torch.clamp(alpha * torch.clamp(excl_min - beta, min=0.0),
                               0.0, 8.7)
        sbit = (mask & (q < 0)).to(torch.int32)
        par = torch.sum(sbit, dim=-1, keepdim=True)
        sign_excl = (1 - 2 * ((par - sbit) & 1)).to(q.dtype)
        return torch.where(mask, sign_excl * excl_min, 0.0)
    t = torch.where(mask, torch.tanh(0.5 * q), 1.0)
    ones = torch.ones_like(t[..., :1])
    fwd = torch.cat([ones, torch.cumprod(t, dim=-1)[..., :-1]], dim=-1)
    bwd = torch.cat([ones, torch.cumprod(t.flip(-1), dim=-1)[..., :-1]],
                    dim=-1).flip(-1)
    prod_excl = torch.clamp(fwd * bwd, -0.9999999, 0.9999999)
    return torch.where(mask, 2.0 * torch.atanh(prod_excl), 0.0)


# at most ldpc_layered's threads a block, and a block's shared memory on
# Hopper
_LDPC_THREADS, _BLOCK_SMEM = 512, 227 * 1024


@dataclasses.dataclass(frozen=True)
class LdpcGeometry:
    """How ldpc_layered lays a plan on the card, a block a row:
    `row_threads` threads a block, each lane holding `slots_lane` edges of
    a check and `checks_lane` checks of a layer, a layer's checks in
    `passes` passes; `shared_bytes` of shared memory a block."""
    row_threads: int
    checks_lane: int
    slots_lane: int
    passes: int
    shared_bytes: int


def ldpc_shared_bytes(n: int, n_edges: int, layer_scratch: int,
                      n_layers: int, layer_slots: int) -> int:
    """Shared memory of a block (csrc/ldpc_layered.cu's ldpc_smem): the
    row's posterior, messages and deltas (float32), the check words and
    two syndrome flags (int32) and the edges' variables (16 bits)."""
    return (4 * (n + n_edges + layer_scratch + n_layers * layer_slots + 2)
            + 2 * n_edges)


def ldpc_geometry(n: int, n_edges: int, n_layers: int, max_layer_checks: int,
                  max_degree: int, group: int,
                  layer_scratch: int) -> LdpcGeometry:
    """The launch geometry of a plan: the fewest passes over a layer's
    checks that _LDPC_THREADS threads allow, one check a lane where that
    takes no more passes than two, in the fewest whole warps (so the
    most rows an SM). On the card (PERF.md §6) a layer in one pass beat
    twice the rows an SM in two."""
    smem = ldpc_shared_bytes(n, n_edges, layer_scratch, n_layers,
                             max_layer_checks)
    if smem > _BLOCK_SMEM:
        raise ValueError(f"a row of {n} variables and {n_edges} edges does "
                         f"not fit a block's shared memory")
    groups = _LDPC_THREADS // group
    passes = -(-max_layer_checks // (2 * groups))
    checks = 1 if -(-max_layer_checks // groups) == passes else 2
    per_pass = -(-max_layer_checks // passes)       # checks a pass
    need = -(-per_pass // checks)                   # groups a pass
    return LdpcGeometry(-(-need * group // 32) * 32, checks,
                        -(-max_degree // group), passes, smem)


@dataclasses.dataclass(frozen=True, eq=False)
class LdpcPlan:
    """A layered decoding schedule in CSR form (fec.ldpc.pack_plan builds
    it), the operand of ldpc_layered and its plain version. Tables (int32):
    the checks of layer l are [layer_ptr[l], layer_ptr[l+1]); the edges of
    check c are [check_ptr[c], check_ptr[c+1]), in position order, edge e
    on variable edge_var[e]; layer l touches the variables var_id[j] for j
    in [var_ptr[l], var_ptr[l+1]), variable j on the edges var_edge[k] for
    k in [var_edge_ptr[j], var_edge_ptr[j+1]), ascending. disjoint: no two
    checks of a layer share a variable. The kernel's lane-order tables:
    lane_check [n_layers * max_layer_checks] int32, the i-th check of
    layer l in word l * max_layer_checks + i as its first edge | its
    degree << 16 (0 past the layer's checks), and lane_var [n_edges]
    int16, edge_var in 16 bits; lane lg of a check of degree d holds its
    positions lg * kc + k, k < kc = ceil(d / group). `group` lanes a check
    (a power of two, at most 32, each lane holding at most 2 edges),
    `layer_scratch` floats of shared memory for a grouped layer's deltas
    (0 when disjoint), and the launch `geometry` (LdpcGeometry)."""
    TABLES: ClassVar[tuple] = ("layer_ptr", "check_ptr", "edge_var",
                               "var_ptr", "var_id", "var_edge_ptr",
                               "var_edge", "lane_check", "lane_var")
    # what the kernel reads, in its entry point's order
    KERNEL_TABLES: ClassVar[tuple] = ("lane_check", "lane_var", "var_ptr",
                                      "var_id", "var_edge_ptr", "var_edge")
    rate_num: int
    n: int
    disjoint: bool
    n_layers: int
    n_checks: int
    n_edges: int
    max_layer_checks: int
    max_degree: int
    group: int
    layer_scratch: int
    geometry: LdpcGeometry
    layer_ptr: torch.Tensor
    check_ptr: torch.Tensor
    edge_var: torch.Tensor
    var_ptr: torch.Tensor
    var_id: torch.Tensor
    var_edge_ptr: torch.Tensor
    var_edge: torch.Tensor
    lane_check: torch.Tensor
    lane_var: torch.Tensor

    @classmethod
    def from_arrays(cls, rate_num: int, n: int, disjoint: bool,
                    **tables) -> "LdpcPlan":
        arr = {k: np.asarray(v, dtype=np.int32) for k, v in tables.items()}
        lp, cp = arr["layer_ptr"], arr["check_ptr"]
        n_layers, n_edges = len(lp) - 1, int(cp[-1])
        max_layer_checks = int(np.diff(lp).max())
        deg = np.diff(cp)
        max_degree = int(deg.max())
        group = min(32, 1 << (max_degree - 1).bit_length())
        if -(-max_degree // group) > _LDPC_KMAX:
            raise ValueError(f"check degree {max_degree} above "
                             f"{32 * _LDPC_KMAX}")
        if n > 1 << 15 or n_edges >= 1 << 16:
            raise ValueError(f"{n} variables or {n_edges} edges do not fit "
                             f"the kernel's 16-bit tables")
        layer_scratch = 0 if disjoint else int(np.diff(cp[lp]).max())
        layer = np.repeat(np.arange(n_layers), np.diff(lp))
        lane_check = np.zeros((n_layers, max_layer_checks), np.int32)
        lane_check[layer, np.arange(len(deg)) - lp[layer]] = \
            cp[:-1] | deg << 16
        arr["lane_check"] = lane_check.reshape(-1)
        arr["lane_var"] = arr["edge_var"].astype(np.int16)
        geometry = ldpc_geometry(n, n_edges, n_layers, max_layer_checks,
                                 max_degree, group, layer_scratch)
        return cls(rate_num=rate_num, n=n, disjoint=bool(disjoint),
                   n_layers=n_layers, n_checks=len(deg), n_edges=n_edges,
                   max_layer_checks=max_layer_checks, max_degree=max_degree,
                   group=group, layer_scratch=layer_scratch,
                   geometry=geometry,
                   **{k: torch.as_tensor(v) for k, v in arr.items()})

    def with_tables(self, tables: dict) -> "LdpcPlan":
        """The same plan with its tables replaced (e.g. moved to a card)."""
        return dataclasses.replace(self, **tables)


def _padded_plan(plan: LdpcPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """The plan in layer_plan's padded layout: (edge_idx [L, Pl*Cw] int64,
    padded edges at the dummy variable slot N; mask [L, Pl, Cw] bool)."""
    lp, cp = plan.layer_ptr.long(), plan.check_ptr.long()
    dev = lp.device
    pl, cw = plan.max_layer_checks, plan.max_degree
    layer = torch.repeat_interleave(torch.arange(plan.n_layers, device=dev),
                                    lp[1:] - lp[:-1])
    row = torch.arange(plan.n_checks, device=dev) - lp[layer]
    check = torch.repeat_interleave(torch.arange(plan.n_checks, device=dev),
                                    cp[1:] - cp[:-1])
    pos = torch.arange(plan.n_edges, device=dev) - cp[check]
    slot = (layer[check] * pl + row[check]) * cw + pos
    size = plan.n_layers * pl * cw
    edge_idx = torch.full((size,), plan.n, dtype=torch.int64, device=dev)
    edge_idx[slot] = plan.edge_var.long()
    mask = torch.zeros(size, dtype=torch.bool, device=dev)
    mask[slot] = True
    return (edge_idx.reshape(plan.n_layers, pl * cw),
            mask.reshape(plan.n_layers, pl, cw))


def layered_sweep_ref(llr: torch.Tensor, r_msgs: list, edge_idx: torch.Tensor,
                      mask: torch.Tensor, algo: str, alpha: float,
                      beta: float):
    """One sweep of the plain layered decode over every layer: the
    posterior llr [B, N] and the check messages r_msgs (a [B, Pl, Cw] a
    layer) -> (posterior, new messages). The posterior read into a check
    update and the delta written back are rounded to bfloat16; a layer's
    deltas are added to a scratch row in edge order (index_add_) and the
    row to the posterior."""
    b, n = llr.shape
    _, pl, cw = mask.shape
    pad = torch.zeros_like(llr[:, :1])
    r_new_all = []
    for l in range(mask.shape[0]):
        idx = edge_idx[l]
        r_old = r_msgs[l]
        post = torch.cat([_bf16(llr), pad], dim=-1)
        q = post[:, idx].reshape(b, pl, cw) - r_old
        r_new = check_node_update(q, mask[l], algo, alpha, beta)
        delta = _bf16((r_new - r_old).reshape(b, -1))
        upd = torch.zeros((b, n + 1), dtype=llr.dtype,
                          device=llr.device).index_add_(1, idx, delta)
        llr = llr + upd[:, :n]
        r_new_all.append(r_new)
    return llr, r_new_all


def layered_decode_ref(llr: torch.Tensor, plan: LdpcPlan, max_iter: int,
                       algo: str = "spa", alpha: float = 1.0,
                       beta: float = 0.0, soft: bool = False):
    """Plain version of ldpc_layered: the sweeps run from the host, every
    row of the batch together, converged rows frozen, with one host read
    of the done mask a sweep. The plan's tables are laid out as layer_plan
    pads them (_padded_plan) and the syndrome is taken over the padded
    checks (an all-padding row has even parity)."""
    llr = llr.to(torch.float32)
    b = llr.shape[0]
    edge_idx, mask = _padded_plan(plan)
    n_l, pl, cw = mask.shape
    check_var = edge_idx.reshape(n_l * pl, cw)

    def syndrome_ok(x):
        bits = torch.cat([(x < 0).long(),
                          torch.zeros_like(x[:, :1], dtype=torch.long)], -1)
        return torch.all(bits[:, check_var].sum(dim=-1) % 2 == 0, dim=-1)

    done = syndrome_ok(llr)
    iters = torch.where(done, 0, max_iter + 1)
    r_msgs = [torch.zeros((b, pl, cw), dtype=torch.float32,
                          device=llr.device) for _ in range(n_l)]
    llr_tot = llr
    it = 0
    while it < max_iter and not bool(done.all()):
        llr_new, r_new = layered_sweep_ref(llr_tot, r_msgs, edge_idx, mask,
                                           algo, alpha, beta)
        conv = syndrome_ok(llr_new)
        keep = done[:, None]
        llr_tot = torch.where(keep, llr_tot, llr_new)
        r_msgs = [torch.where(keep[:, :, None], r0, r1)
                  for r0, r1 in zip(r_msgs, r_new)]
        iters = torch.where(conv & ~done, it + 1, iters)
        done = done | conv
        it += 1
    bits = (llr_tot < 0).long()
    if soft:
        return bits, iters, done, llr_tot
    return bits, iters, done


def ldpc_launch_args(llr: torch.Tensor, plan: LdpcPlan, outs: tuple,
                     max_iter: int, algo: str, alpha: float,
                     beta: float) -> tuple:
    """The C entry point's arguments but the stream: llr [B, N] float32
    and the plan's tables on one card, outs (bits, iters, ok, posterior or
    None) allocated."""
    geo = plan.geometry
    return (llr.data_ptr(),
            *[getattr(plan, t).data_ptr() for t in LdpcPlan.KERNEL_TABLES],
            *[None if t is None else t.data_ptr() for t in outs],
            llr.shape[0], plan.n, plan.n_layers, plan.n_edges,
            plan.max_layer_checks, plan.layer_scratch, plan.group,
            geo.slots_lane, geo.checks_lane, geo.row_threads, int(max_iter),
            int(algo == "minsum"), float(alpha), float(beta))


def ldpc_layered(llr: torch.Tensor, plan: LdpcPlan, max_iter: int,
                 algo: str = "spa", alpha: float = 1.0, beta: float = 0.0,
                 soft: bool = False):
    """Layered BP decode of llr [B, N] on plan (fec.ldpc.pack_plan):
    "spa" or offset min-sum (alpha, beta) check updates, at most max_iter
    sweeps -> (bits [B, N] int64, iters [B] int64, ok [B] bool), plus the
    posterior [B, N] float32 with soft (the contract of
    layered_decode_ref, the plain version).

    CUDA: one launch, a block a row of plan.geometry's threads, the row's
    posterior and check messages and the plan's lane-order tables in
    shared memory; every sweep, the convergence test and the outputs in
    the kernel, on the operands' current stream, with no host read until
    the decode ends. The plan's tables must lie on llr's card."""
    if llr.device.type == "cpu":
        return layered_decode_ref(llr, plan, max_iter, algo, alpha, beta,
                                  soft)
    _require(llr.device.type == "cuda", f"unsupported device {llr.device}")
    _require(algo in ("spa", "minsum"), "algo must be 'spa' or 'minsum'")
    _require(llr.dim() == 2 and llr.shape[1] == plan.n,
             f"ldpc_layered: llr {tuple(llr.shape)} is not [B, {plan.n}]")
    _require(max_iter >= 0, "ldpc_layered: max_iter must be >= 0")
    for name in LdpcPlan.KERNEL_TABLES:
        t = getattr(plan, name)
        _require(t.device == llr.device and t.is_contiguous() and t.dtype ==
                 (torch.int16 if name == "lane_var" else torch.int32),
                 f"ldpc_layered: the plan's {name} must be contiguous "
                 f"{'int16' if name == 'lane_var' else 'int32'} on "
                 f"{llr.device}")
    llr = llr.to(torch.float32).contiguous()
    b, n = llr.shape
    dev = llr.device
    bits = torch.empty((b, n), dtype=torch.int64, device=dev)
    iters = torch.empty((b,), dtype=torch.int64, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    post = (torch.empty((b, n), dtype=torch.float32, device=dev) if soft
            else None)
    if b > 0:
        _launch("ldpc_layered", llr, native.load_library().ldpc_launch,
                *ldpc_launch_args(llr, plan, (bits, iters, ok, post),
                                  max_iter, algo, alpha, beta))
    return (bits, iters, ok, post) if soft else (bits, iters, ok)
