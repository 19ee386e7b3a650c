"""The benchmark's fixed arithmetic: the card's peaks, the least time a
kernel's work could take, percentiles and the device's busy union.

The roofline counts are copies of the port's `tools/roofline.py` (`bound`,
`ldpc_counts`, `fir_window_samples`, `fir_bound`), so a later change to the
program's kernels is measured against the same work whatever implements it.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.txref import LDPC_TABLES, N_LDPC

# one NVIDIA H100 SXM (data sheet, at the 700 W limit): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# operations per edge of a check-node update and its message exchange in
# one layered sweep
EDGE_FLOPS = {"spa": 24, "minsum": 10}


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take: compulsory bytes over the HBM
    rate or FP32 operations over their peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3


def ldpc_edges(rate_num: int) -> int:
    """Edges of the rate's parity-check graph (the copied code tables)."""
    c_idx = np.load(LDPC_TABLES)[f"{rate_num}_16_C"]
    return int((c_idx >= 0).sum())


def ldpc_bound_ms(rate_num: int, rows: int, algo: str, sweeps: float,
                  soft: bool) -> float:
    """A whole layered decode of `rows` codewords: reads the channel LLRs
    [rows, N] float32, writes the decisions [rows, N] int64, iterations
    int64 and ok bool (and the posterior float32 with soft); EDGE_FLOPS an
    edge a sweep at the rows' mean sweeps."""
    n, edges = N_LDPC, ldpc_edges(rate_num)
    nbytes = 4 * rows * n + 8 * rows * n + 9 * rows + (4 * rows * n if soft else 0)
    return bound_ms(nbytes, EDGE_FLOPS[algo] * edges * rows * sweeps)


def fir_window_samples(n: int, start: np.ndarray, n_out: int, stride: int,
                       offset: int, ntaps: int) -> tuple[int, int]:
    """(passband samples the FIR reads over all rows, oscillator samples it
    reads once): each row's input window clipped to [0, n)."""
    start = np.asarray(start, np.int64)
    lo = np.clip(start + offset - (ntaps - 1), 0, n)
    hi = np.clip(start + offset + (n_out - 1) * stride + 1, 0, n)
    used = np.zeros(n + 1, np.int64)
    np.add.at(used, lo, 1)
    np.add.at(used, hi, -1)
    return int((hi - lo).sum()), int((np.cumsum(used)[:n] > 0).sum())


def fir_bound_ms(rows: int, n: int, start: np.ndarray, n_out: int,
                 stride: int, offset: int, ntaps: int, freq: bool) -> float:
    """mix_fir_decimate's work. Bytes: the passband windows (4 B), the
    oscillator over their union (8 B), taps, per-row offsets (4 B), output
    (8 B); operations: 2 a sample mixed (8 with a per-row offset), 4 a tap
    of an output."""
    pb_n, osc_n = fir_window_samples(n, start, n_out, stride, offset, ntaps)
    nbytes = (4 * pb_n + 8 * osc_n + 4 * ntaps + 8 * rows * n_out
              + (4 * rows if freq else 0))
    return bound_ms(nbytes, (8 if freq else 2) * pb_n
                    + 4 * rows * n_out * ntaps)


def nearest_rank(values, q: float) -> float:
    """The q-quantile of all values by nearest rank: an observed value."""
    v = sorted(values)
    return v[max(math.ceil(q * len(v)) - 1, 0)]


def busy_union(intervals, lo: float, hi: float) -> tuple[float, list]:
    """(time covered by the union of intervals clipped to [lo, hi], the
    idle gaps between them as (start, end))."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += e - max(s, cur)
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps
