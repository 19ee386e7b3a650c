"""Per-stage roofline of the port's receive on the CUDA card (the
counterpart of the repo root's tools/roofline.py and tools/roofline_k.py).

Each stage of a CONFIG_9 receive at batch 256 runs alone on inputs of the
receive's shapes, beside the work its function must do:

- bytes: each input read once and each output written once, at the
  interface's types; operations: the arithmetic the algorithm needs
  (the counts are of the function, not of an implementation, so a later
  hand kernel for the same stage is held to the same number);
- bound: the larger of the bytes over the H100's HBM rate and the
  operations over the peak rate of their type (bound()); share: the bound
  over the measured time. A share above SHARE_LIMIT means a count or a
  timing is wrong: the tool fails, as it fails when any stage fails.

Times, on the card only (CUDA events; each stage warmed up first):
- device_ms: the stage alone between two events, the L2 flushed (a
  256 MiB write) before each of `reps` launches, averaged. A stage of one
  kernel (the five hand kernels: the LDPC sweep and whole decode are
  ldpc_layered launches) is launched raw, through the kernel library's C
  entry point on prepared operands; a stage of many torch launches (the
  Schmidl-Cox metric, the demod, the estimate, the plain LDPC sweep) is
  captured once as a CUDA graph and the graph is replayed, so the host's
  launch time is not in it; a stage with host synchronizations inside
  (the plain whole LDPC decode, a whole receive) runs eagerly, and its
  device_ms holds the host's waits too;
- warm_ms: `reps` back-to-back launches between one pair of events, the
  inputs left in the L2 (50 MB) where they fit;
- host_ms: the host wall of one eager call through its Python entry point,
  ending in a synchronize (median of 5): for a stage of many launches the
  gap between host_ms and device_ms is the host's launch time;
- device_ops and busy_ms: the device operations of one eager call and
  their summed time, from torch.profiler.

launches_a_receive counts each stage's calls in a receive of
bench.bench_buffer (CONFIG_9, and CONFIG_3 and 0 for their scans), the
LDPC decodes and their sweeps at the buffer's 12 dB; deep_mf_score's
calls are told apart by their window: the whole-buffer scan's
(SCAN_WINDOW) or a refine's.

    python -m mercury_tpu_torch.tools.roofline --out docs/roofline_h100.json
    python -m mercury_tpu_torch.tools.roofline --cpu   # the counts only

Without a card and without --cpu it exits 1; --cpu builds every stage on
the CPU and writes its counts (timing needs the card).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from mercury_tpu_torch import bench, native
from mercury_tpu_torch.convert import card_meta, cli_device
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.dsp import kernels, ops
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.fec.tables import load_code
from mercury_tpu_torch.modem import sync
from mercury_tpu_torch.modem.rx import RxChain

BATCH = 256
CFG = 9
# H100 SXM (NVIDIA data sheet; dense tensor-core rates, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"FP32": 67e12, "TF32": 495e12, "BF16": 989e12}
L2_BYTES = 50e6
FLUSH_BYTES = 256 * 2 ** 20
SHARE_LIMIT = 1.05
# per-edge operations of a check-node update and its message exchange in one
# sweep (the JAX tool's roofline.py:190 and roofline_k.py:220 counts): SPA,
# min-sum; a flooding sweep adds the variable-node update
EDGE_FLOPS = {"spa": 24, "minsum": 10, "flooding": 30}
NEAR_THRESHOLD_SIGMA = 0.9          # the JAX tool's whole-decode LLRs
# BPSK noise sigma near each rate's waterfall: spread over 0.85-1.1 x it,
# about half the rows of a batch decode within 50 sweeps (SPA and min-sum;
# the plain decoder on the CPU, 32 rows)
LDPC_SIGMA = {1: 2.5, 2: 1.9, 3: 1.55, 4: 1.3, 5: 1.15, 6: 1.05, 8: 0.9,
              14: 0.5}
# lags each side of the CONFIG_3 whole-buffer scan (RxChain._refine_arbitrate's
# win_g: (29648 // 2 - 4 * 136) // 2); a refine's window is a few symbols
SCAN_WINDOW = 7140


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: compulsory bytes over the HBM
    rate or operations over the peak of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "flop_kind": kind}


# ---------------------------------------------------------------------------
# the hand kernels' counts and raw launches
# ---------------------------------------------------------------------------

def fir_window_samples(n: int, start: torch.Tensor, n_out: int,
                       stride: int, offset: int, ntaps: int):
    """(passband samples the FIR reads over all rows, oscillator samples it
    reads once): each row's input window clipped to [0, n)."""
    lo = torch.clamp(start + offset - (ntaps - 1), 0, n)
    hi = torch.clamp(start + offset + (n_out - 1) * stride + 1, 0, n)
    used = torch.zeros(n + 1, dtype=torch.int32, device=start.device)
    used.index_add_(0, lo, torch.ones_like(lo, dtype=torch.int32))
    used.index_add_(0, hi, -torch.ones_like(hi, dtype=torch.int32))
    return int((hi - lo).sum()), int((used.cumsum(0)[:n] > 0).sum())


def fir_bound(b: int, n: int, start, n_out: int, stride: int, offset: int,
              ntaps: int, freq: bool = False) -> dict:
    """mix_fir_decimate's bound. Bytes: the passband windows (4 B), the
    oscillator over their union (8 B), taps, per-row offsets (4 B), output
    (8 B); flops: 2 per sample mixed (8 with a per-row offset: the complex
    product of the oscillator and the rotation too; the sine and cosine,
    special-function work, are not counted), 4 per tap of an output
    (FP32)."""
    pb_n, osc_n = fir_window_samples(n, start, n_out, stride, offset, ntaps)
    return bound(4 * pb_n + 8 * osc_n + 4 * ntaps + 8 * b * n_out
                 + (4 * b if freq else 0),
                 (8 if freq else 2) * pb_n + 4 * b * n_out * ntaps, "FP32")


def mf_bound(rows: int, seg_len: int, bank_shape, n_cand: int,
             out_bytes: int, per_lag: bool = True) -> dict:
    """Matched-filter bound: seg (8 B a sample), bank, outputs of out_bytes
    per (row, lag), or with per_lag False per (row, hypothesis)
    (deep_mf_best); 8 flops per complex multiply-add at the TF32 peak."""
    a, lp, s = bank_shape
    outs = rows * (n_cand if per_lag else a)
    return bound(8 * rows * seg_len + 8 * a * lp * s + out_bytes * outs,
                 8.0 * rows * a * n_cand * lp * s, "TF32")


def pcs_bound(bb_dec, idx0, fidx, bank) -> dict:
    """pilot_cand_score's bound. Bytes: each row's samples under some
    candidate, the bank rows referenced, starts, rows, energies and scores;
    flops: 8 per complex multiply-add and 4 per sample energy (FP32)."""
    b, n_dec = bb_dec.shape
    m = idx0.shape[1]
    _, nsym, s_d = bank.shape
    span = nsym * s_d
    st, fr = kernels._clip_candidates(n_dec, idx0, fidx, bank)
    cover = torch.zeros((b, n_dec + 1), dtype=torch.int32,
                        device=bb_dec.device)
    one = torch.ones_like(st, dtype=torch.int32)
    cover.scatter_add_(1, st, one)
    cover.scatter_add_(1, st + span, -one)
    row_samples = int((cover.cumsum(1)[:, :n_dec] > 0).sum())
    n_rows_used = int(torch.unique(fr).numel())
    return {**bound(8 * row_samples + 8 * n_rows_used * span + 16 * b * m
                    + 4 * nsym + 4 * b * m, 12.0 * b * m * span, "FP32"),
            "bank_rows": n_rows_used}


def fir_raw(pb, osc, taps, stride, start=None, n_out=None, offset=None,
            freq=None, fs=None):
    """A raw launch of mix_fir_decimate on the wrapper's operands (the
    output allocated once, outside the timing)."""
    lib = native.load_library()
    b, n = pb.shape
    ntaps = taps.shape[0]
    if start is None:
        n_out, offset = (n - 1) // stride + 1, (ntaps - 1) // 2
    dst = torch.empty((b, n_out), dtype=torch.complex64, device=pb.device)
    return lambda: lib.mfd_launch(
        pb.data_ptr(), osc.data_ptr(), taps.data_ptr(),
        None if start is None else start.data_ptr(),
        None if freq is None else freq.data_ptr(),
        0.0 if freq is None else float(fs), dst.data_ptr(), b, n, n_out,
        stride, offset, ntaps, kernels._stream(pb))


def mf_raw(name: str, seg, bank, window: int, outs):
    """A raw launch of a matched-filter kernel (deep_mf_score, deep_mf_max
    or deep_mf_best) on _dmf_operands' operands (packing and prefix sums
    done once, outside the timing)."""
    lib = native.load_library()
    best = name == "deep_mf_best"
    seg, tmpl, ce, ef = kernels._dmf_operands(
        seg, bank, window, name,
        kernels._dmf_best_bank if best else kernels._dmf_kernel_bank)
    b, seg_len = seg.shape
    a, lp, s = bank.shape
    operands = (seg, tmpl, ce, ef, *outs)        # alive as long as the launch
    ptrs = [t.data_ptr() for t in operands]
    if best:
        return lambda: lib.dmf_best_launch(*ptrs, b, a, seg_len, lp, s,
                                           2 * window + 1,
                                           kernels._stream(seg))
    fn = lib.dmf_launch if name == "deep_mf_score" else lib.dmf_max_launch
    return lambda: fn(*ptrs, b, a, seg_len, lp, s, 2 * window + 1,
                      8 * tmpl.shape[2], kernels._stream(seg))


def pcs_raw(bb_dec, idx0, fidx, bank, prepared=None):
    """A raw launch of pilot_cand_score on the wrapper's operands (the
    baseband at its own strides; the kernel clips the candidates)."""
    lib = native.load_library()
    b, n_dec = bb_dec.shape
    m = idx0.shape[1]
    f_n, nsym, s_d = bank.shape
    bank_t, e_t = prepared or kernels.pilot_bank(bank)
    res = torch.empty((b, m), dtype=torch.float32, device=bb_dec.device)
    operands = (bb_dec, idx0.long().contiguous(), fidx.long().contiguous(),
                bank_t, e_t, res)
    return lambda: lib.pcs_launch(
        *[t.data_ptr() for t in operands], b, n_dec, bb_dec.stride(0),
        bb_dec.stride(1), m, f_n, nsym, s_d, kernels._stream(bb_dec))


# ---------------------------------------------------------------------------
# the torch-op stages' counts
# ---------------------------------------------------------------------------

def sc_counts(b: int, n_bb: int, n_scan: int, lp: int, cs: int) -> dict:
    """Schmidl-Cox metric and CFO over bb [b, n_bb] complex -> two
    [b, n_scan] float32 outputs. Operations a sample: the two lag products
    (6 each) and the energy (3), their prefix sums (2 + 2 + 1); a box-sum
    position (n_scan + cs of them): 7 differences; a candidate: the sums
    over lp preamble symbols of 5 series (7 (lp - 1)) and the metric's
    magnitudes, normalization, gates and angle (15)."""
    return bound(8 * b * n_bb + 8 * b * n_scan,
                 b * (20 * n_bb + 7 * (n_scan + cs)
                      + (7 * (lp - 1) + 15) * n_scan), "FP32")


def demod_counts(b: int, nsym: int, nofdm: int, nfft: int, nc: int) -> dict:
    """The OFDM demod (the JAX tools' count, roofline_k.py:176-180): 5 Nfft
    log2 Nfft operations an FFT, [b, nsym, nofdm] complex in, the
    [b, nsym, nc] carriers out."""
    return bound(8 * b * nsym * (nofdm + nc),
                 b * nsym * 5 * nfft * math.log2(nfft), "FP32")


def est_counts(b: int, n_pilots: int, cells: int) -> dict:
    """The dense LS estimate y [b, n_pilots] complex @ est_op.T [n_pilots,
    cells] float32 (the JAX tools' count, roofline_k.py:189-192), at full
    FP32 as the receive runs it."""
    return bound(4 * (n_pilots * cells + b * (2 * n_pilots + 2 * cells)),
                 2 * 2 * b * n_pilots * cells, "FP32")


def ldpc_counts(code, b: int, kind: str, sweeps: float = 1.0,
                whole: bool = False, soft: bool = False) -> dict:
    """LDPC work over the code's edges E (EDGE_FLOPS[kind] operations an
    edge a sweep, `sweeps` sweeps a row). One sweep (whole=False) reads and
    writes the posterior [b, N] and the check messages [b, E] (float32);
    a whole decode (whole=True) reads the channel LLRs [b, N] float32 and
    writes the decisions [b, N] int64, iterations [b] int64 and ok [b]
    bool, and with soft the posterior [b, N] float32, its messages staying
    inside it."""
    n = code.n
    edges = int((np.asarray(code.c_idx) >= 0).sum())
    nbytes = (4 * b * n + 8 * b * n + 9 * b + (4 * b * n if soft else 0)
              if whole else 4 * b * (2 * n + 2 * edges))
    return {**bound(nbytes, EDGE_FLOPS[kind] * edges * b * sweeps, "FP32"),
            "edges": edges, "sweeps": sweeps}


def ldpc_sweeps(iters: torch.Tensor, max_iter: int) -> float:
    """The mean sweeps a decode's rows ran: iters, with a row that never
    converged (max_iter + 1) counted at max_iter."""
    return float(torch.clamp(iters, 0, max_iter).double().mean())


def ldpc_bound(llr, plan, max_iter: int, algo: str = "spa",
               alpha: float = 1.0, beta: float = 0.0, soft: bool = False,
               iters: torch.Tensor | None = None) -> dict:
    """ldpc_layered's bound on the wrapper's operands: a whole decode's
    bytes and its operations at the sweeps this decode's rows ran (iters,
    its output)."""
    return ldpc_counts(load_code(plan.rate_num), llr.shape[0], algo,
                       ldpc_sweeps(iters, max_iter), whole=True, soft=soft)


def ldpc_raw(llr, plan, max_iter: int, algo: str = "spa", alpha: float = 1.0,
             beta: float = 0.0, soft: bool = False):
    """A raw launch of ldpc_layered on the wrapper's operands (outputs
    allocated once, outside the timing)."""
    lib = native.load_library()
    b, n = llr.shape
    dev = llr.device
    outs = (torch.empty((b, n), dtype=torch.int64, device=dev),
            torch.empty((b,), dtype=torch.int64, device=dev),
            torch.empty((b,), dtype=torch.bool, device=dev),
            torch.empty((b, n), dtype=torch.float32, device=dev)
            if soft else None)
    llr = llr.float().contiguous()
    args = kernels.ldpc_launch_args(llr, plan, outs, max_iter, algo, alpha,
                                    beta)
    # outs as a default: the launch writes into them, so they live as long
    # as it does
    return lambda outs=outs: lib.ldpc_launch(*args, kernels._stream(llr))


# The SPA bars of ldpc_layered against its plain version (ldpc_agree): a
# decode that ran k <= LDPC_FEW_SWEEPS sweeps, whose trajectories have not
# parted yet, is held element by element: its posterior within
# LDPC_POST_BARS[k][0] and bit-equal on all but the share
# LDPC_POST_BARS[k][1] of its elements. Each is about 3x the largest
# reading of tools/ldpc_fault_check.py (8 rates, batch 256 at mixed noise,
# on an NVIDIA H100 80GB HBM3): after 1, 2, 3 sweeps the kernel parts from
# the plain version on the card by at most 0.031, 0.063, 0.081, on a share
# 1.4e-4, 1.6e-3, 7.7e-3 of the elements; built with --use_fast_math on
# 2.0e-3 or more of them after one sweep, without a bf16 rounding on 0.35
# or more.
LDPC_POST_BARS = {1: (0.1, 5e-4), 2: (0.2, 5e-3), 3: (0.25, 2.5e-2)}
LDPC_FEW_SWEEPS = max(LDPC_POST_BARS)


def ldpc_agree(got, want, algo: str, label: str, max_iter: int) -> tuple:
    """The kernel's decode `got` against the plain version's `want`, both
    (bits, iters, ok[, posterior]) of a decode of at most max_iter sweeps.
    Min-sum: every output equal. SPA: ok different on at most 1% of the
    rows (rounded down: none below 100 rows); bits equal where both
    converged; the posterior equal in sign where both converged at the
    same sweep, and the decisions its signs. A decode that ran k <=
    LDPC_FEW_SWEEPS sweeps (max_iter, or every row of both converged by
    then) also has iters within one on every row and the posterior within
    LDPC_POST_BARS[k]'s limit, bit-equal on all but its share. Over more sweeps a last-ulp tanhf/atanhf difference
    steers a row near the waterfall (the plain version on the card and on
    the CPU part by up to 6 sweeps and 50 in a posterior LLR:
    tools/ldpc_plain_spread.py), so those bars hold over few sweeps only.
    -> (max abs err: of the posterior on the rows held, else whether the
    bits differ; text)."""
    soft = len(got) == 4
    if algo == "minsum":
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"{label}: min-sum not bit-exact"
        return 0.0, "min-sum bit-exact in every output"
    bits, iters, ok = got[:3]
    bits_p, iters_p, ok_p = want[:3]
    n_ok = int((ok != ok_p).sum())
    assert n_ok <= ok.numel() // 100, f"{label}: ok differs on {n_ok}"
    both = ok & ok_p
    assert torch.equal(bits[both], bits_p[both]), f"{label}: bits differ"
    same = both & (iters == iters_p)
    ran = min(max_iter, int(torch.maximum(iters, iters_p).max())
              ) if ok.numel() else 0
    few = ran <= LDPC_FEW_SWEEPS
    rows = torch.ones_like(ok) if few else both
    d_it = (iters - iters_p)[rows].abs().max().item() if rows.any() else 0
    assert not few or d_it <= 1, f"{label}: iters apart by {d_it}"
    text = (f"SPA over {ran} sweeps: ok differs on {n_ok}/"
            f"{ok.numel()} rows, bits equal on {int(both.sum())} converged "
            f"in both, iters apart by up to {d_it}")
    if not soft:
        return float((bits[both] != bits_p[both]).any()), text
    post, post_p = got[3], want[3]
    assert torch.equal(torch.sign(post[same]), torch.sign(post_p[same])), (
        f"{label}: posterior signs differ")
    assert torch.equal(bits, (post < 0).long()), label
    rows = rows if few else same
    gap = (post[rows] - post_p[rows]).abs()
    err = gap.max().item() if gap.numel() else 0.0
    if not few:
        return err, (text + f"; posterior signs equal on {int(same.sum())} "
                     f"rows converged at the same sweep (max abs err there "
                     f"{err:.3e})")
    off = (gap > 0).double().mean().item()
    atol, share = LDPC_POST_BARS[max(ran, 1)]
    assert err <= atol and off <= share, (
        f"{label}: posterior max abs err {err:.3e}, {off:.2e} of it not "
        f"bit-equal")
    return err, (text + f"; posterior within {atol} (max abs err "
                 f"{err:.3e}), not bit-equal on {off:.2e} of it (at most "
                 f"{share})")


def ldpc_mixed_llr(rate: int, batch: int, seed: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(codewords [batch, N] int64, channel LLRs [batch, N] float32) on the
    CPU: random codewords of the rate as BPSK through AWGN, row r at sigma
    LDPC_SIGMA[rate] x (0.85 + 0.25 r / (batch - 1)), so some rows decode
    and some do not."""
    code = load_code(rate)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.integers(0, 2, (batch, code.k)))
    cw = ldpc.encode(torch.as_tensor(code.gen.astype(np.float32)), u)
    sig = LDPC_SIGMA[rate] * np.linspace(0.85, 1.1, batch)[:, None]
    y = (1 - 2 * cw.numpy()) + sig * rng.standard_normal(cw.shape)
    return cw, torch.as_tensor((2 / sig ** 2 * y).astype(np.float32))


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

@dataclass
class Stage:
    """One stage: its counts and how to run it. make() allocates the
    inputs on the device and returns {"eager": the call through its Python
    entry point, "raw": a raw kernel launch or None, "graph": whether the
    eager call can be captured as a CUDA graph}, and for a whole decode
    "sweeps" (an output's mean sweeps) and "recount" (the counts at those
    sweeps). receive: (config, key of counting()'s calls, "" for none)."""
    name: str
    shape: str
    counts: dict
    make: Callable[[], dict]
    replaces: str = ""
    note: str = ""
    receive: tuple = ("CONFIG_9", "")


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(shape, seed: int, device, complex_=False):
    """Seeded normal samples made on the CPU and moved: the same inputs on
    any device."""
    g = _gen(seed)
    x = torch.randn(shape, generator=g)
    if complex_:
        x = torch.complex(x, torch.randn(shape, generator=g))
    return x.to(device)


def stages(device) -> list[Stage]:
    """Every stage of the roofline at BATCH, its counts made now and its
    inputs on `device` when run."""
    device = torch.device(device)
    g = build_geometry(CFG)
    rx = RxChain(g, device=device)
    n = g.nofdm * g.buffer_nsymb * g.interp
    ntaps_ts, ntaps_d = rx._fir_ts.shape[0], rx._fir_data.shape[0]
    n_ts = (n - 1) // g.interp + 1
    out = []

    # --- the TS FIR: mixer + strided FIR over the whole buffer ---
    def make_ts():
        pb = 0.3 * _randn((BATCH, n), 1, device)
        osc = rx._osc_const(n)
        args = (pb, osc, rx._fir_ts, g.interp)
        return {"eager": lambda: kernels.mix_fir_decimate(*args),
                "raw": fir_raw(*args), "graph": False}
    zeros = torch.zeros(BATCH, dtype=torch.int64)
    out.append(Stage(
        "TS FIR", f"[{BATCH},{n}] s{g.interp} -> [{BATCH},{n_ts}], "
        f"{ntaps_ts} taps",
        fir_bound(BATCH, n, zeros, n_ts, g.interp, (ntaps_ts - 1) // 2,
                  ntaps_ts), make_ts,
        "mercury_tpu/dsp/pallas_kernels.py:143",
        "kernels.mix_fir_decimate, the strided 'same' form",
        ("CONFIG_9", "ts")))

    # --- the data FIR: per-row start, the frame's samples ---
    frame = g.nofdm * (rx.active_nsymb + g.preamble_nsymb) * g.interp
    n_data = frame // g.interp
    off = ntaps_d - 1 - (ntaps_d - 1) // 2
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    start = torch.full((BATCH,), delay, dtype=torch.int64)

    def make_data():
        pb = 0.3 * _randn((BATCH, n), 2, device)
        args = (pb, rx._osc_const(n), rx._fir_data, g.interp)
        kw = dict(start=start.to(device), n_out=n_data, offset=off)
        return {"eager": lambda: kernels.mix_fir_decimate(*args, **kw),
                "raw": fir_raw(*args, **kw), "graph": False}
    out.append(Stage(
        "data FIR", f"[{BATCH},{n}] at per-row starts -> [{BATCH},{n_data}]"
        f", {ntaps_d} taps",
        fir_bound(BATCH, n, start, n_data, g.interp, off, ntaps_d),
        make_data, "mercury_tpu/dsp/pallas_kernels.py:143",
        "kernels.mix_fir_decimate, per-row starts (the frame of bench's "
        "buffer)", ("CONFIG_9", "data")))

    # --- the Schmidl-Cox metric over the TS baseband ---
    sc_scan = 4 if (g.ngi % 4 == 0 and g.nfft % 8 == 0) else 1
    s_sym = g.nofdm // sc_scan
    n_scan = -(-max(n_ts - g.preamble_nsymb * g.nofdm, 1) // sc_scan)
    cs = (g.preamble_nsymb - 1) * s_sym

    def make_sc():
        bb = 0.1 * _randn((BATCH, n_ts), 3, device, complex_=True)
        return {"eager": lambda: sync.schmidl_cox_metric(
            bb, g, decim=g.interp, scan=sc_scan), "raw": None, "graph": True}
    out.append(Stage(
        "Schmidl-Cox metric", f"[{BATCH},{n_ts}] c64 -> 2 x "
        f"[{BATCH},{n_scan}], scan {sc_scan}",
        sc_counts(BATCH, n_ts, n_scan, g.preamble_nsymb, cs), make_sc,
        note="sync.schmidl_cox_metric: lag products, cumsum box sums",
        receive=("CONFIG_9", "sc")))

    # --- the OFDM demod ---
    nsym = rx.active_nsymb

    def make_demod():
        sym = _randn((BATCH, nsym, g.nofdm), 4, device, complex_=True)
        return {"eager": lambda: ops.ofdm_demod(sym, rx._pad_map, g.nfft,
                                                g.ngi),
                "raw": None, "graph": True}
    out.append(Stage(
        "OFDM demod", f"[{BATCH},{nsym},{g.nofdm}] c64 -> "
        f"[{BATCH},{nsym},{g.nc}], FFT {g.nfft}",
        demod_counts(BATCH, nsym, g.nofdm, g.nfft, g.nc), make_demod,
        note="ops.ofdm_demod: torch.fft", receive=("CONFIG_9", "demod")))

    # --- the channel estimate ---
    est_op = rx._est_op
    cells, n_pil = est_op.shape

    def make_est():
        y = _randn((BATCH, n_pil), 5, device, complex_=True)

        def est():
            with ops.full_fp32_matmul():
                return torch.complex(y.real @ est_op.T, y.imag @ est_op.T)
        return {"eager": est, "raw": None, "graph": True}
    out.append(Stage(
        "channel estimate", f"[{BATCH},{n_pil}] c64 x [{n_pil},{cells}]",
        est_counts(BATCH, n_pil, cells), make_est,
        note="the dense est_op product at full FP32 (TF32 off)",
        receive=("CONFIG_9", "est")))

    # --- LDPC: one layered sweep (SPA, min-sum), whole decodes, flooding;
    # the kernel's rows and the plain version's ---
    code = load_code(g.spec.ldpc_rate_num)
    rate = g.spec.ldpc_rate_num
    # the JAX tool's near-threshold LLRs: BPSK at sigma 0.9
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.integers(0, 2, (BATCH, code.k)))
    cw = ldpc.encode(torch.as_tensor(code.gen.astype(np.float32)), u)
    sigma = NEAR_THRESHOLD_SIGMA
    y = (1 - 2 * cw.numpy()) + sigma * rng.standard_normal(cw.shape)
    llr_nt = torch.as_tensor((2 / sigma ** 2 * y).astype(np.float32))
    n_layers = ldpc.pack_plan(rate).n_layers

    def kernel_decode(algo, max_iter):
        """A decode through the kernel's wrapper (eager) and as a raw
        launch, its counts recomputed at the sweeps its rows ran."""
        dec = ldpc.LayeredDecoder(rate, max_iter, algo=algo).to(device)
        llr = llr_nt.to(device)
        args = (llr, dec.plan, max_iter, algo, dec.alpha, dec.beta)
        return {"eager": lambda: dec(llr),
                "raw": ldpc_raw(*args) if device.type == "cuda" else None,
                "graph": False,
                "sweeps": lambda out: ldpc_sweeps(out[1], max_iter),
                "recount": lambda sweeps: ldpc_counts(
                    code, BATCH, algo, sweeps, whole=True)}

    for algo in ("spa", "minsum"):
        out.append(Stage(
            f"LDPC layered sweep ({algo})",
            f"[{BATCH},{code.n}] rate {rate}/16, {n_layers} layers, "
            f"max_iter 1",
            ldpc_counts(code, BATCH, algo, whole=True),
            lambda algo=algo: kernel_decode(algo, 1),
            "mercury_tpu/fec/ldpc.py:386",
            "kernels.ldpc_layered with max_iter 1: the channel LLRs in, "
            "one sweep and two syndromes, decisions out (one launch)",
            ("CONFIG_9", "sweep" if algo == "spa" else "")))

        def make_sweep(algo=algo):
            dec = ldpc.LayeredDecoder(rate, algo=algo).to(device)
            edge_idx, mask = kernels._padded_plan(dec.plan)
            llr = 4.0 * _randn((BATCH, code.n), 6, device)
            r_msgs = [0.5 * _randn((BATCH, *mask.shape[1:]), 7 + i, device)
                      * mask[i] for i in range(mask.shape[0])]
            return {"eager": lambda: kernels.layered_sweep_ref(
                llr, r_msgs, edge_idx, mask, algo, dec.alpha, dec.beta),
                "raw": None, "graph": True}
        out.append(Stage(
            f"LDPC layered sweep ({algo}, plain)",
            f"[{BATCH},{code.n}] rate {rate}/16, {n_layers} layers",
            ldpc_counts(code, BATCH, algo), make_sweep,
            note="plain: kernels.layered_sweep_ref, torch ops a layer",
            receive=("CONFIG_9", "")))

    for algo in ("spa", "minsum"):
        out.append(Stage(
            f"LDPC whole decode ({algo})",
            f"[{BATCH},{code.n}] at sigma {sigma}, up to 50 sweeps",
            ldpc_counts(code, BATCH, algo, whole=True),
            lambda algo=algo: kernel_decode(algo, 50),
            "mercury_tpu/fec/ldpc.py:386",
            "kernels.ldpc_layered: one launch, no host read inside",
            ("CONFIG_9", "ldpc" if algo == "spa" else "")))

        def make_decode(algo=algo):
            dec = ldpc.LayeredDecoder(rate, algo=algo).to(device)
            llr = llr_nt.to(device)
            return {"eager": lambda: kernels.layered_decode_ref(
                llr, dec.plan, 50, algo, dec.alpha, dec.beta),
                "raw": None, "graph": False,
                "sweeps": lambda out: ldpc_sweeps(out[1], 50),
                "recount": lambda sweeps: ldpc_counts(
                    code, BATCH, algo, sweeps, whole=True)}
        out.append(Stage(
            f"LDPC whole decode ({algo}, plain)",
            f"[{BATCH},{code.n}] at sigma {sigma}, up to 50 sweeps",
            ldpc_counts(code, BATCH, algo, whole=True), make_decode,
            note="plain: kernels.layered_decode_ref, a host read a sweep",
            receive=("CONFIG_9", "")))

    def make_flood():
        dec = ldpc.FloodingDecoder(rate, max_iter=1).to(device)
        llr = llr_nt.to(device)
        return {"eager": lambda: dec(llr), "raw": None, "graph": False}
    out.append(Stage(
        "LDPC flooding sweep", f"[{BATCH},{code.n}], max_iter 1",
        ldpc_counts(code, BATCH, "flooding", whole=True), make_flood,
        note="FloodingDecoder(max_iter=1).forward: the channel LLRs in, "
        "decisions out", receive=("CONFIG_9", "")))

    # --- the matched filters and the pilot scores (CONFIG_3, CONFIG_0) ---
    rx3 = RxChain(build_geometry(3), device=device)
    tmpl = rx3._mf_templates[:, ::8]
    bank3 = rx3._rotated_bank(tmpl, np.arange(-4, 5) * 30.0, 8)
    w = SCAN_WINDOW
    seg_len = 2 * w + bank3.shape[1] * bank3.shape[2]

    def make_scan(bank, fused):
        def make():
            seg = 0.05 * _randn((BATCH, seg_len), 8, device, complex_=True)
            a = bank.shape[0]
            if fused:
                outs = [torch.empty((BATCH, a), device=device),
                        torch.empty((BATCH, a), dtype=torch.int64,
                                    device=device)]
                eager = lambda: kernels.deep_mf_best_fused(seg, bank, w)
            else:
                outs = [torch.empty((BATCH, a, 2 * w + 1), device=device)]
                eager = lambda: kernels.deep_mf_score(seg, bank, w)
            name = "deep_mf_best" if fused else "deep_mf_score"
            return {"eager": eager,
                    "raw": mf_raw(name, seg, bank, w, outs)
                    if device.type == "cuda" else None, "graph": False}
        return make
    out.append(Stage(
        "CONFIG_3 scan", f"[{BATCH},{seg_len}]x{list(bank3.shape)} w={w}",
        mf_bound(BATCH, seg_len, bank3.shape, 2 * w + 1, 12, per_lag=False),
        make_scan(bank3, True), "mercury_tpu/modem/sync.py:197",
        "kernels.deep_mf_best_fused (wgmma TF32, the best lag of each "
        "hypothesis)", ("CONFIG_3", "scan")))
    bank17 = rx3._rotated_bank(tmpl, np.arange(-8, 9) * 15.0, 8)
    out.append(Stage(
        "CONFIG_3 scan, full profile",
        f"[{BATCH},{seg_len}]x{list(bank17.shape)} w={w}",
        mf_bound(BATCH, seg_len, bank17.shape, 2 * w + 1, 4),
        make_scan(bank17, False), "mercury_tpu/dsp/pallas_kernels.py:298",
        "kernels.deep_mf_score (wgmma TF32, the score surface): "
        "deep_profile=\"full\"'s 17-row grid", ("CONFIG_3", "")))

    rx0 = RxChain(build_geometry(0), device=device)
    _, bank0, pil, prepared = rx0._coherent_banks(8)
    seg_len0 = 2 * w + bank0.shape[-1]

    def make_max():
        seg = 0.05 * _randn((BATCH, seg_len0), 9, device, complex_=True)
        outs = [torch.empty((BATCH, 2 * w + 1), device=device),
                torch.empty((BATCH, 2 * w + 1), dtype=torch.int64,
                            device=device)]
        return {"eager": lambda: kernels.deep_mf_max(seg, bank0, w),
                "raw": mf_raw("deep_mf_max", seg, bank0, w, outs)
                if device.type == "cuda" else None, "graph": False}
    out.append(Stage(
        "CONFIG_0 coherent scan", f"[{BATCH},{seg_len0}]x"
        f"{list(bank0.shape)} w={w}",
        mf_bound(BATCH, seg_len0, bank0.shape, 2 * w + 1, 12), make_max,
        "mercury_tpu/dsp/pallas_kernels.py:404",
        "kernels.deep_mf_max (wgmma TF32)", ("CONFIG_0", "dmax")))

    n_dec, m = 14824, 32
    span = pil.shape[1] * pil.shape[2]
    gi = _gen(10)
    idx0 = torch.randint(0, n_dec - span + 1, (BATCH, m), generator=gi)
    fidx = torch.randint(0, pil.shape[0], (BATCH, m), generator=gi)
    def make_pcs():
        bb = _randn((BATCH, n_dec), 11, device, complex_=True)
        args = (bb, idx0.to(device), fidx.to(device), pil)
        return {"eager": lambda: kernels.pilot_cand_score(*args, prepared),
                "raw": pcs_raw(*args, prepared)
                if device.type == "cuda" else None, "graph": False}
    out.append(Stage(
        "CONFIG_0 pilot scores", f"[{BATCH},{n_dec}] M={m} "
        f"x{list(pil.shape)}",
        pcs_bound(torch.empty((BATCH, n_dec), dtype=torch.complex64),
                  idx0, fidx, pil.cpu()), make_pcs,
        "mercury_tpu/dsp/pallas_kernels.py:573",
        "kernels.pilot_cand_score: its one launch is a cluster launch "
        "(cudaLaunchKernelEx), which torch.profiler has not listed (0 "
        "device ops)", ("CONFIG_0", "pcs")))
    return out


# ---------------------------------------------------------------------------
# timing (the card only)
# ---------------------------------------------------------------------------

def _require_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise RuntimeError("roofline timing needs a CUDA device (the counts "
                           "alone run anywhere)")


def _graph(fn: Callable) -> Callable:
    """fn captured as a CUDA graph (after three warm-up calls on a side
    stream) -> a call that replays it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def flushed_ms(run: Callable, flush: torch.Tensor, reps: int) -> float:
    """Mean device time of run() between two events, the L2 flushed (a
    write of `flush`) before each of reps launches."""
    pairs = []
    for _ in range(reps):
        flush.add_(1.0)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def checked(launch: Callable, name: str) -> Callable:
    """A raw launch (a C entry point returning a cudaError_t) as a call
    that fails on a launch error."""
    def run():
        err = launch()
        assert err == 0, f"{name}: launch failed: cudaError_t {err}"
    return run


def warm_ms(run: Callable, reps: int) -> float:
    """Mean device time of reps back-to-back run()s between two events,
    after one warm-up run()."""
    run()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn: Callable, reps: int = 5) -> float:
    """Median host wall of one fn() ending in a synchronize."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def profile_call(fn: Callable) -> tuple[int, float]:
    """(device operations, their summed ms) of one fn(), from
    torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops_ = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ops_), sum(e.time_range.elapsed_us() for e in ops_) / 1e3


def time_stage(st: Stage, device, flush: torch.Tensor, reps: int,
               profile: bool = True) -> dict:
    """Every time of a stage (module docstring) -> its result fields; a
    stage with host synchronizations inside has no warm_ms (its host waits
    dominate either way); device_ops and busy_ms only with `profile`. The
    whole decodes also get their mean sweeps and the counts they imply."""
    _require_card(device)
    call = st.make()
    eager = call["eager"]
    first = eager()
    torch.cuda.synchronize()
    res = {}
    if "sweeps" in call:
        res["sweeps"] = call["sweeps"](first)
        st.counts = call["recount"](res["sweeps"])
    del first
    if call["raw"] is not None:
        run = checked(call["raw"], st.name)
        res["timing"] = "raw kernel launch"
    elif call["graph"]:
        run = _graph(eager)
        res["timing"] = "CUDA graph replay"
    else:
        run = eager
        res["timing"] = "eager calls (host synchronizations inside)"
    run()
    torch.cuda.synchronize()
    res["device_ms"] = flushed_ms(run, flush, reps)
    res["warm_ms"] = (warm_ms(run, reps) if run is not eager else None)
    res["host_ms"] = host_ms(eager, min(5, reps))
    res["device_ops"], res["busy_ms"] = (profile_call(eager) if profile
                                         else (None, None))
    del call, eager, run
    return res


@contextlib.contextmanager
def counting(rx: RxChain):
    """Count, while inside, the calls a receive of rx makes of each stage:
    kernels' wrappers (the TS FIR: no per-row starts; the data FIR: with
    them; deep_mf_best, by the fused kernel or the surface: the
    whole-buffer scan at SCAN_WINDOW, else a refine),
    sync.schmidl_cox_metric, ops.ofdm_demod, the grid statistics (one
    channel estimate each), the LDPC decodes (kernels.ldpc_layered) and
    their sweeps (the most any row
    of a decode ran, summed)."""
    calls = {k: 0 for k in ("ts", "data", "scan", "refine", "dmax", "pcs",
                            "sc", "demod", "est", "ldpc", "sweep")}
    saved = [(kernels, "mix_fir_decimate"), (kernels, "deep_mf_best"),
             (kernels, "deep_mf_max"), (kernels, "pilot_cand_score"),
             (sync, "schmidl_cox_metric"), (ops, "ofdm_demod"),
             (kernels, "ldpc_layered")]
    originals = [getattr(mod, name) for mod, name in saved]

    def counted(key, fn):
        def f(*args, **kw):
            k = key(args, kw) if callable(key) else key
            calls[k] += 1
            return fn(*args, **kw)
        return f
    fir_key = (lambda a, kw: "data" if kw.get("start") is not None
               or len(a) > 4 else "ts")
    dmf_key = (lambda a, kw: "scan" if kw.get("window", a[2]) == SCAN_WINDOW
               else "refine")
    def ldpc_swept(fn):
        def f(llr, plan, max_iter, *args, **kw):
            out = fn(llr, plan, max_iter, *args, **kw)
            calls["sweep"] += int(torch.clamp(out[1], 0, max_iter).max()
                                  ) if out[1].numel() else 0
            return out
        return f
    for (mod, name), fn, key in zip(saved, originals, (
            fir_key, dmf_key, "dmax", "pcs", "sc", "demod", "ldpc")):
        setattr(mod, name, counted(key, ldpc_swept(fn) if key == "ldpc"
                                   else fn))
    rx._grid_stats_internal = counted("est", rx._grid_stats_internal)
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)
        del rx._grid_stats_internal


def receive_counts(device, profile: bool = True) -> dict:
    """{config label: the stage calls of one receive of
    bench.bench_buffer and its decoded rows} for CONFIG_9, 3 and 0, and
    under "timed" CONFIG_9's receive: device_ms (events around 5 eager
    receives, the host's waits inside), host_ms, and with `profile`
    device_ops and busy_ms."""
    out = {}
    for cfg in (9, 3, 0):
        g = build_geometry(cfg)
        rx = RxChain(g, device=device)
        buf, _, _ = bench.bench_buffer(g, device)
        rx.receive(buf)
        with counting(rx) as calls:
            res = rx.receive(buf)
        out[f"CONFIG_{cfg}"] = {**calls,
                                "decoded": int(res.crc_ok.sum())}
        if cfg == CFG:
            def call():
                return rx.receive(buf)
            ops_n, busy = profile_call(call) if profile else (None, None)
            out["timed"] = {
                "config": cfg, "batch": buf.shape[0],
                "device_ms": warm_ms(call, 5), "host_ms": host_ms(call),
                "device_ops": ops_n, "busy_ms": busy,
                "decoded": out[f"CONFIG_{cfg}"]["decoded"]}
        del rx, buf
    return out


def run(device, reps: int = 20, profile: bool = True) -> dict:
    """Every stage timed on the card beside its counts -> the record
    {"meta", "stages", "receive"}; `profile`: also each eager call's
    device operations (torch.profiler: tens of seconds on the whole
    decodes' events). Raises if a stage's share exceeds SHARE_LIMIT (after
    logging every stage)."""
    _require_card(device)
    flush = torch.zeros(FLUSH_BYTES // 4, device=device)
    rec = receive_counts(device, profile)
    rows = []
    for st in stages(device):
        t0 = time.perf_counter()
        res = time_stage(st, device, flush, reps, profile)
        label, key = st.receive
        c = st.counts
        row = {"stage": st.name, "shape": st.shape, "replaces": st.replaces,
               "note": st.note, **res,
               "launches_a_receive": ({"config": label,
                                       "calls": rec[label][key]}
                                      if key else None),
               **{k: c[k] for k in ("bytes", "flops", "flop_kind",
                                    "bound_ms", "bound_by")},
               "share": c["bound_ms"] / res["device_ms"],
               "l2": ("flushed before each launch (device_ms); warm_ms: "
                      "back-to-back on the same inputs")}
        rows.append(row)
        warm = ("n/a" if res["warm_ms"] is None
                else f"{res['warm_ms']:.4f}")
        busy = ("" if res["busy_ms"] is None else
                f", {res['device_ops']} device ops busy "
                f"{res['busy_ms']:.4f} ms")
        print(f"{st.name:28s} device {res['device_ms']:9.4f} ms (warm "
            f"{warm}), host {res['host_ms']:9.4f} ms{busy}; "
            f"bound {c['bound_ms']:.4g} ms by {c['bound_by']} "
            f"({c['bytes'] / 1e6:.2f} MB, {c['flops'] / 1e9:.3f} GFLOP "
            f"{c['flop_kind']}): share {100 * row['share']:.1f}%"
            + (f"; {res['sweeps']:.2f} sweeps" if "sweeps" in res else "")
            + f" [{time.perf_counter() - t0:.1f} s]")
    del flush
    record = {"meta": {**card_meta(device), "batch": BATCH,
                       "config": CFG, "reps": reps,
                       "hbm_bytes_per_s": HBM_BYTES_PER_S,
                       "peak_flops": PEAK_FLOPS, "l2_bytes": L2_BYTES,
                       "share_limit": SHARE_LIMIT},
              "stages": rows, "receive": rec}
    over = [r["stage"] for r in rows if r["share"] > SHARE_LIMIT]
    if over:
        raise RuntimeError(f"share above {SHARE_LIMIT:.0%} (a count or a "
                           f"timing is wrong): {over}")
    return record


def counts_only(device) -> dict:
    """Every stage's counts, untimed (the whole decodes per sweep)."""
    return {"meta": {**card_meta(device), "batch": BATCH,
                     "config": CFG, "timed": False},
            "stages": [{"stage": st.name, "shape": st.shape,
                        **{k: st.counts[k] for k in (
                            "bytes", "flops", "flop_kind", "bound_ms",
                            "bound_by")}}
                       for st in stages(device)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.tools.roofline",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="write the record as JSON")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="the counts only, on the CPU (timing needs the "
                    "card)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1
    record = (counts_only(device) if device.type == "cpu"
              else run(device, args.reps))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}")
    else:
        print(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
