"""Observability: the program's span recorder and RX diagnostics arrays
(PyTorch port of the JAX package's `obs.py`; `waterfall` is host numpy,
copied as it is).

Spans. The receive and the serving pool mark where their work happens with
`span(name, n=0, device=False)`:

    rx.acquire         RxChain.receive's front end, sync and refinement
                       (device extent too)
    rx.deep_scan       inside it on CONFIG_0: the coherent scan, its pooled
                       top peaks, the pilot-lattice re-score and the pick;
                       n = the rows scanned (device extent too)
    rx.nc_scan         inside it on CONFIG_1-4 (deep sync, not coherent):
                       the noncoherent whole-buffer scan, its best lag for
                       each CFO-grid row; n = the rows scanned (device
                       extent too)
    rx.decode          its first decode and the rescue decode, recovery
                       included (device extent too)
    rx.rescue          CONFIG_0's runner-up decode of the failed rows and
                       the merge, only where a row with a runner-up failed
                       its CRC; n = the rows decoded again (device extent
                       too)
    rx.recovery        one BICM-ID, DD or MFSK runner-up pass over the rows
                       that failed; n = those rows
    rx.read            each host read of a device value inside the receive
                       (the recovery loop's rows, the rescue's rows): the
                       host waiting on the card
    pool.unpack.build  FusedDevicePool.unpack after its one D2H copy: the
                       columns and the per-channel RxResults; n = the
                       results built

A span is recorded only while torch.profiler records (its active steps:
torch.autograd.profiler._is_profiler_enabled) or inside `recording()`;
otherwise it costs one flag test and records nothing. A recorded span
keeps its host start and end (time.perf_counter_ns, the clock of
time.perf_counter) and its n in a bounded ring of numpy columns (the
oldest are lost once it wraps; no Python object a span), and with device
set a pair of CUDA events on the current stream, from a small pool, whose
time apart (the span's extent on the card's timeline, queueing included)
is read when the spans are. While the profiler records, each span is also
a torch.profiler.record_function range, so it shows under its name in an
exported Chrome or Perfetto trace.

Read them with `spans()`: a dict of arrays, oldest first, of the spans
closed so far (name, start_ns, end_ns, n, device_ms). Under a profiler of
your own:

    with torch.profiler.profile(...) as prof:
        pool.unpack(pool.round(block))
    s = obs.spans()
    blocked_ms = (s["end_ns"] - s["start_ns"])[s["name"] == "rx.read"].sum() / 1e6

`tools/profile_torch_rx.py` profiles receives the same way; `clear()`
empties the ring. The benchmark's per-layer metrics read these spans
(`benchmark/spans.py`).
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16          # spans the ring keeps
EVENT_PAIRS = 64            # CUDA event pairs, reused in turn
_OFF = nullcontext()


class _Ring:
    """The recorded spans: one row a span, row = seq % capacity."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.seq = np.full(capacity, -1, np.int64)
        self.name = np.zeros(capacity, np.int32)
        self.start = np.zeros(capacity, np.int64)
        self.end = np.full(capacity, -1, np.int64)
        self.n = np.zeros(capacity, np.int64)
        self.slot = np.full(capacity, -1, np.int32)
        self.count = itertools.count()      # next() is atomic under the GIL


_ring = _Ring(CAPACITY)
_names: dict[str, int] = {}
_name_list: list[str] = []
_forced = 0
_local = threading.local()
# event pair k: (device, start event, end event), and the span that holds it
_pairs: list = [None] * EVENT_PAIRS
_pair_seq = np.full(EVENT_PAIRS, -1, np.int64)
_pair_count = itertools.count()


def _name_id(name: str) -> int:
    i = _names.get(name)
    if i is None:
        i = _names[name] = len(_name_list)
        _name_list.append(name)
    return i


def _stream(device):
    """The CUDA stream a device span records on, or None (no card)."""
    if device is True:
        return (torch.cuda.current_stream()
                if torch.cuda.is_available() else None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.current_stream(device)
    return None


class _Span:
    """An open span; one a nesting depth a thread, made once and reused."""

    __slots__ = ("stack", "seq", "slot", "stream", "rf")

    def __init__(self, stack):
        self.stack = stack
        self.rf = None

    def open(self, name: str, n: int, device):
        ring = _ring
        seq = self.seq = next(ring.count)
        row = seq % ring.capacity
        ring.seq[row] = seq
        ring.name[row] = _name_id(name)
        ring.n[row] = n
        ring.end[row] = -1
        ring.slot[row] = self.slot = -1
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(name)
            self.rf.__enter__()
        ring.start[row] = time.perf_counter_ns()
        stream = self.stream = _stream(device) if device else None
        if stream is not None:
            k = next(_pair_count) % EVENT_PAIRS
            pair = _pairs[k]
            if pair is None or pair[0] != stream.device:
                pair = _pairs[k] = (stream.device,
                                    torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True))
            pair[1].record(stream)
            _pair_seq[k] = seq
            ring.slot[row] = self.slot = k
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.stream is not None:
            _pairs[self.slot][2].record(self.stream)
            self.stream = None
        t = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        row = self.seq % _ring.capacity
        if _ring.seq[row] == self.seq:      # not overwritten by a wrap
            _ring.end[row] = t
        self.stack.depth -= 1
        return False


class _Stack:
    """A thread's open spans."""

    def __init__(self):
        self.depth = 0
        self.spans: list[_Span] = []


def _open(name: str, n: int, device) -> _Span:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = _Stack()
    if stack.depth == len(stack.spans):
        stack.spans.append(_Span(stack))
    h = stack.spans[stack.depth].open(name, n, device)
    stack.depth += 1
    return h


def span(name: str, n: int = 0, device=False):
    """Context manager marking a stretch of the program's work as `name`,
    with an integer n carried along (a row count). device: True (the
    current CUDA device) or a torch.device also times the span on that
    card's current stream; a CPU device gives no device time. Records
    only while torch.profiler records or inside recording()."""
    if not (_profiler._is_profiler_enabled or _forced):
        return _OFF
    return _open(name, n, device)


@contextmanager
def recording():
    """Record spans inside the block whether or not a profiler runs."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def clear() -> None:
    """Forget every recorded span."""
    global _ring
    _ring = _Ring(CAPACITY)
    _pair_seq.fill(-1)


def spans() -> dict:
    """The closed spans in the ring, oldest first, as arrays: name (str),
    start_ns and end_ns (time.perf_counter_ns), n, and device_ms, the card's
    ms from the span's start event to its end event (NaN for a span
    without its events: no device asked, or their pair reused since);
    device_ms is None when no span has a device time (always off the
    card). Waits for the card to reach each end event it reads."""
    ring = _ring
    rows = np.flatnonzero((ring.seq >= 0) & (ring.end >= 0))
    rows = rows[np.argsort(ring.seq[rows], kind="stable")]
    dev = np.full(rows.size, np.nan)
    for i in np.flatnonzero(ring.slot[rows] >= 0):
        row, k = rows[i], ring.slot[rows[i]]
        if _pair_seq[k] == ring.seq[row]:
            _dev, start, end = _pairs[k]
            end.synchronize()
            dev[i] = start.elapsed_time(end)
    return {"name": np.array(_name_list, dtype=str)[ring.name[rows]],
            "start_ns": ring.start[rows], "end_ns": ring.end[rows],
            "n": ring.n[rows],
            "device_ms": None if np.isnan(dev).all() else dev}


def waterfall(samples: np.ndarray, fs: float = 48000.0, nfft: int = 512,
              hop: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Spectrogram array (dB) for waterfall display (reference:
    gui/waterfall.cc 512-pt FFT feed). Returns (spec [frames, nfft//2+1],
    freqs)."""
    samples = np.asarray(samples, dtype=np.float64)
    n_frames = max((len(samples) - nfft) // hop + 1, 0)
    win = np.hanning(nfft)
    rows = np.empty((n_frames, nfft // 2 + 1))
    for i in range(n_frames):
        seg = samples[i * hop: i * hop + nfft] * win
        rows[i] = 20 * np.log10(np.abs(np.fft.rfft(seg)) + 1e-12)
    return rows, np.fft.rfftfreq(nfft, 1 / fs)


def rx_diagnostics(rx_chain, pb_buffer: np.ndarray) -> dict:
    """One-shot RX diagnostics for notebooks, on rx_chain's device: the
    Schmidl-Cox metric curve of the TS-FIR baseband (OFDM), the detected
    delay, CRC, SNR and frequency offset, the equalized constellation and
    the channel magnitude over the frame grid (OFDM) or the tone energies
    (MFSK), and the waterfall: the arrays the reference feeds its GUI.
    Every array returned is numpy on the host."""
    from mercury_tpu_torch.modem import sync as sync_mod

    g = rx_chain.geom
    buf = torch.as_tensor(np.asarray(pb_buffer, np.float32)[None],
                          device=rx_chain.device)
    out: dict = {}
    with torch.no_grad():
        if not g.spec.is_mfsk:
            bb = rx_chain.to_baseband(buf, 0.0, data_fir=False)
            met, _cfo = sync_mod.schmidl_cox_metric(bb, g)
            out["sync_metric"] = met[0].cpu().numpy()
        res = rx_chain.receive(buf)
        delay = int(res.delay[0])
        freq = float(res.freq_offset[0])
        out.update(delay=delay, crc_ok=bool(res.crc_ok[0]),
                   snr_db=float(res.snr_db[0]), freq_offset=freq)
        # equalized constellation and channel estimate
        bb_d = rx_chain.to_baseband(buf, freq, data_fir=True)
        frame = rx_chain.extract_frame(bb_d, torch.tensor([delay]))
        grid = rx_chain.demod_grid(frame)
        if not g.spec.is_mfsk:
            eq, variance, _mean_h, _vf = rx_chain.grid_stats(grid)
            out["constellation"] = eq[0, rx_chain._data_cells].cpu().numpy()
            y_pil = grid.reshape(1, -1)[:, rx_chain._pilot_cells]
            est = rx_chain._est_op
            h = torch.complex(y_pil.real @ est.T, y_pil.imag @ est.T)
            out["channel_mag"] = torch.abs(h)[0].reshape(
                g.nsymb, g.nc).cpu().numpy()
            out["pilot_variance"] = float(variance[0])
        else:
            out["tone_energy"] = (torch.abs(grid[0]) ** 2).cpu().numpy()
    out["waterfall"], out["waterfall_freqs"] = waterfall(pb_buffer)
    return out
