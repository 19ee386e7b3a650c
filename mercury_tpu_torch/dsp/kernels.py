"""The receive path's two hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel (built at first use by `native.load_library`)
or raises; there is no fallback. `LAUNCHES` counts kernel launches, one per
wrapper call that reaches the card.
"""

from __future__ import annotations

import torch

from mercury_tpu_torch import native
from mercury_tpu_torch.dsp import ops

LAUNCHES = {"mix_fir_decimate": 0, "deep_mf_score": 0}


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

def mix_fir_decimate_ref(pb: torch.Tensor, osc: torch.Tensor,
                         taps: torch.Tensor, stride: int,
                         start: torch.Tensor | None = None,
                         n_out: int | None = None,
                         offset: int | None = None) -> torch.Tensor:
    """Plain version: mix with the oscillator table, then the strided 'same'
    FIR (start None) or the segment FIR at per-row starts.

    pb [B, n] real; osc [n] complex; taps [T] real. start None gives
    fir_same(pb*osc)[:, ::stride]. With a start [B] (and n_out, offset),
    out[b, m] = sum_j taps[j] * x[b, start[b] + m*stride + offset - j] for
    m < n_out, x = pb*osc zero outside [0, n)."""
    x = pb * osc
    if start is None:
        return ops.fir_same_strided(x, taps, stride)
    ntaps = taps.shape[0]
    n = pb.shape[-1]
    seg_len = n_out * stride + ntaps - 1
    lo = offset - (ntaps - 1)                    # seg[k] = x[start + lo + k]
    pad_l = max(-lo, 0)
    pad_r = max(int(start.max()) + lo + seg_len - n, 0)
    xp = torch.nn.functional.pad(x, (pad_l, pad_r))
    idx = (start + lo + pad_l)[:, None] + torch.arange(
        seg_len, device=pb.device)[None]
    seg = torch.gather(xp, 1, idx)
    return ops.fir_decimate_segment(seg, taps, stride)


def mix_fir_decimate(pb: torch.Tensor, osc: torch.Tensor, taps: torch.Tensor,
                     stride: int, start: torch.Tensor | None = None,
                     n_out: int | None = None,
                     offset: int | None = None) -> torch.Tensor:
    """Real passband [B, n] -> complex baseband [B, n_out]: mixer and
    decimating FIR in one pass (see mix_fir_decimate_ref for the function).

    CUDA: float32 pb, complex64 osc, float32 taps, int64 start, all on one
    device; output complex64."""
    if pb.device.type == "cpu":
        return mix_fir_decimate_ref(pb, osc, taps, stride, start, n_out,
                                    offset)
    _require(pb.device.type == "cuda", f"unsupported device {pb.device}")
    b, n = pb.shape
    ntaps = taps.shape[0]
    if start is None:                      # "same" alignment from sample 0
        start = torch.zeros(b, dtype=torch.int64, device=pb.device)
        n_out, offset = (n - 1) // stride + 1, (ntaps - 1) // 2
    elif n_out is None or offset is None:
        raise ValueError("a per-row start needs n_out and offset")
    for t, dt, shape in ((pb, torch.float32, (b, n)),
                         (osc, torch.complex64, (n,)),
                         (taps, torch.float32, (ntaps,)),
                         (start, torch.int64, (b,))):
        _require(t.device == pb.device and t.dtype == dt
                 and tuple(t.shape) == shape and t.is_contiguous(),
                 f"mix_fir_decimate: expected contiguous {dt} {shape} on "
                 f"{pb.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((b, n_out), dtype=torch.complex64, device=pb.device)
    lib = native.load_library()
    err = lib.mfd_launch(pb.data_ptr(), osc.data_ptr(), taps.data_ptr(),
                         start.data_ptr(), out.data_ptr(), b, n, n_out,
                         stride, offset, ntaps, _stream(pb))
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


def deep_mf_score(seg: torch.Tensor, bank: torch.Tensor, window: int,
                  nfft: int | None = None) -> torch.Tensor:
    """Normalized matched-filter scores of bank [A, Lp, S] against seg
    [B, L] at lags 0..2*window -> [B, A, 2*window+1] float32 (before /Lp).

    CUDA: direct time-domain correlation in one kernel; `nfft` is accepted
    for the JAX signature and not needed. Requires L >= 2*window + Lp*S."""
    if seg.device.type == "cpu":
        return deep_mf_score_ref(seg, bank, window, nfft)
    _require(seg.device.type == "cuda", f"unsupported device {seg.device}")
    b, seg_len = seg.shape
    a, lp, s = bank.shape
    n_cand = 2 * window + 1
    _require(seg.dtype == torch.complex64 and bank.dtype == torch.complex64,
             "deep_mf_score: complex64 seg and bank required")
    _require(bank.device == seg.device, "deep_mf_score: bank on another device")
    _require(seg_len >= 2 * window + lp * s,
             f"deep_mf_score: segment {seg_len} shorter than "
             f"2*{window} + {lp}*{s}")
    seg = seg.contiguous()
    # per-(a, l) template normalization and the energy prefix sums stay in
    # torch, as the JAX wrapper keeps them outside its pallas_call
    t_norm = torch.sqrt(torch.sum(torch.abs(bank) ** 2, dim=-1, keepdim=True))
    tmpl = (bank / t_norm).contiguous()
    ce, e_floor = _energy_terms(seg, s)
    ce = ce.contiguous()
    ef = e_floor[:, 0].contiguous()
    out = torch.empty((b, a, n_cand), dtype=torch.float32, device=seg.device)
    lib = native.load_library()
    err = lib.dmf_launch(seg.data_ptr(), tmpl.data_ptr(), ce.data_ptr(),
                         ef.data_ptr(), out.data_ptr(), b, a, seg_len, lp, s,
                         n_cand, _stream(seg))
    _check(err, "deep_mf_score")
    LAUNCHES["deep_mf_score"] += 1
    return out
