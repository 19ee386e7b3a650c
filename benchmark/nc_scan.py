"""CONFIG_1-4's noncoherent whole-buffer scan (the program's first
`deep_mf_score` launch of a receive) and the matched-filter refinement
beside it: a plain reference of the score they compute, and their work
counted from the configuration, so that the kernel's roofline share
measures the same work whatever implements it.

The scan's launch, from the serving pool's window (mercury_tpu_torch at the
commit that added this file, `RxChain._acquire` and `_refine_arbitrate`):

- window: 109 symbols of 1088 samples, 118592 (core/geometry.py,
  scale/serve.py); the time-sync FIR decimates by interp 4 (`ts_dec`),
  29648 samples a row;
- the matched filter's decimation mf_d 8 (1088 divides by 8: `mf_d`), 2
  of those samples a lag (`mf_s`); the template, 4 preamble symbols of
  1088 / 8 = 136 (`tmpl_d`), scored coherently a symbol and summed over
  the symbols;
- lags: (29648 // 2 - 4 x 136) // 2 = 7140 each side (`win_g`), so the
  segment is 2 x 7140 + 544 = 14824 and 2 x 7140 + 1 = 14281 lags are
  scored;
- the bank: a 30 Hz CFO grid over +-120 Hz (`DEEP_GRID_HZ`, the "wide"
  range), 9 rows of the 4 symbols, [9, 4, 136];
- what the receive needs of it: the best lag and its score for each (row,
  grid row), an int64 and a float32, 12 B (`matched_filter_refine_bank`'s
  argmax and gather; the kernel writes the whole score surface today,
  which the count leaves out).

The refinement's launch: the 3 Schmidl-Cox candidates of a row (`n_k`,
"wide") each cut a segment of 2 x 272 + 544 = 1088 around the candidate
(`window` 2 x 1088 interp samples, 272 lags of 8 each side), against the
bank of the 3 CFO aliases [3, 4, 136]; 3 x rows segments of 545 lags,
the same 12 B a (segment, alias) out.

The rows are the program's: the n of its `rx.nc_scan` spans.
"""

from __future__ import annotations

import torch

from benchmark.yardstick import HBM_BYTES_PER_S

# one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): TF32 operations/s
PEAK_TF32_FLOPS = 495e12
SEGMENT = 14824
BANK = (9, 4, 136)
LAGS = 7140
REFINE_CANDIDATES = 3
REFINE_SEGMENT = 1088
REFINE_BANK = (3, 4, 136)
REFINE_LAGS = 272
OUT_BYTES = 12
# the comparison with the program's scan: score / Lp within SCORE_ATOL;
# the delay equal where the best beats every lag more than one step away
# by more than CLEAR_MARGIN (score / Lp). The kernel multiplies TF32
# operands (10 mantissa bits): on the timed path's segments at Es/N0
# 0.75 dB it reads 3.2e-5-3.3e-5 from this reference, as does the reference
# on TF32-rounded operands; on bf16-rounded operands (7 bits) 2.5e-4-2.7e-4.
# SCORE_ATOL lies between, three times above the one and 2.5 below the other.
SCORE_ATOL = 1e-4
CLEAR_MARGIN = 2e-3


def _mf_bound_ms(rows: int, seg_len: int, bank, lags: int) -> float:
    """Reads the segments (8 B a complex sample) and the bank, writes
    OUT_BYTES a (segment, bank row); 8 operations a complex multiply-add,
    at the TF32 peak. The larger of the two times, in ms."""
    a, lp, s = bank
    n_cand = 2 * lags + 1
    nbytes = 8 * rows * seg_len + 8 * a * lp * s + OUT_BYTES * rows * a
    flops = 8.0 * rows * a * n_cand * lp * s
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_TF32_FLOPS) * 1e3


def scan_bound_ms(rows: int) -> float:
    """The scan of `rows` rows: the least time the card could take."""
    return _mf_bound_ms(rows, SEGMENT, BANK, LAGS)


def refine_bound_ms(rows: int) -> float:
    """The refinement of a receive of `rows` rows (REFINE_CANDIDATES
    segments a row): the least time the card could take."""
    return _mf_bound_ms(REFINE_CANDIDATES * rows, REFINE_SEGMENT,
                        REFINE_BANK, REFINE_LAGS)


def scan_ref(seg: torch.Tensor, bank: torch.Tensor,
             window: int) -> torch.Tensor:
    """The scan's score by direct correlation in float64: seg [B, L]
    complex, bank [A, Lp, S] complex -> [B, A, 2 * window + 1],

        score[b, a, d] = sum_l |sum_s seg[b, d + l S + s] conj(bank[a, l, s])|
                         / (sqrt(max(e_l, floor)) ||bank[a, l]||),

    a term 0 where e_l <= floor; e_l the segment's energy over those S
    samples, floor = 1e-4 x the row's mean energy a sample x S + 1e-20."""
    seg = seg.to(torch.complex128)
    bank = bank.to(device=seg.device, dtype=torch.complex128)
    b = seg.shape[0]
    a, lp, s = bank.shape
    n_cand = 2 * window + 1
    energy = seg.real ** 2 + seg.imag ** 2
    floor = 1e-4 * energy.mean(dim=-1, keepdim=True) * s + 1e-20    # [B, 1]
    wins = seg.unfold(-1, s, 1)                          # [B, L - S + 1, S]
    e_win = energy.unfold(-1, s, 1).sum(dim=-1)          # [B, L - S + 1]
    norm = torch.linalg.vector_norm(bank, dim=-1)        # [A, Lp]
    score = torch.zeros((b, n_cand, a), dtype=torch.float64,
                        device=seg.device)
    for l in range(lp):
        corr = wins[:, l * s: l * s + n_cand] @ bank[:, l].conj().T
        e_l = e_win[:, l * s: l * s + n_cand, None]      # [B, n_cand, 1]
        term = corr.abs() / (torch.sqrt(torch.maximum(e_l, floor[..., None]))
                             * norm[:, l])
        score += torch.where(e_l > floor[..., None], term, 0.0)
    return score.transpose(1, 2)


def pick_ref(score: torch.Tensor, lp: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The best lag of each (row, bank row) of scan_ref's score and its
    score over the Lp symbols -> (delay [B, A], score / Lp [B, A])."""
    best, delay = score.max(dim=-1)
    return delay, best / lp


def far_margin(score: torch.Tensor, lp: int) -> torch.Tensor:
    """How far the best score beats every lag more than one step from
    the best lag, over Lp -> [B, A]."""
    best, delay = score.max(dim=-1)
    lag = torch.arange(score.shape[-1], device=score.device)
    far = (lag - delay[..., None]).abs() > 1
    return (best - torch.where(far, score, -torch.inf).amax(dim=-1)) / lp


def compare(seg: torch.Tensor, bank: torch.Tensor, window: int,
            delay: torch.Tensor, score: torch.Tensor,
            block: int = 16) -> dict:
    """The program's scan (delay [B, A] in lags, score / Lp [B, A]) on
    seg and bank against the reference, `block` rows at a time: the
    largest score error, the (row, bank row) pairs whose delay is held
    (far_margin > CLEAR_MARGIN), those of them whose delay differs, and
    whether both bars hold."""
    lp = bank.shape[1]
    err, held, differ = 0.0, 0, 0
    for r in range(0, seg.shape[0], block):
        ref = scan_ref(seg[r: r + block], bank, window)
        d_ref, s_ref = pick_ref(ref, lp)
        clear = far_margin(ref, lp) > CLEAR_MARGIN
        d_got = delay[r: r + block].to(d_ref.device)
        s_got = score[r: r + block].to(s_ref.device, torch.float64)
        err = max(err, float((s_got - s_ref).abs().max()))
        held += int(clear.sum())
        differ += int((clear & (d_got != d_ref)).sum())
    return {"max_abs_err": err, "pairs": int(delay.numel()),
            "delay_held": held, "delay_differs": differ,
            "ok": err <= SCORE_ATOL and differ == 0}
