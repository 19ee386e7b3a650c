"""Serving pool: many independent radio channels, one batched RX dispatch
(PyTorch port of the JAX package's `scale/serve.py`).

A per-channel dispatch would pay a receive's fixed host cost once per
channel; the pools aggregate independent capture streams into batched
receive calls instead.

StreamPool owns a native [n_channels, window_len] circular window pool
(runtime.cc rt_pool — the vectorized form of the reference's capture-prep
protocol, audioio.c:999-1069): feeding is bulk memcpy into per-channel
rings, and each step linearizes EVERY ready channel into contiguous rows in
one native pass, then decodes them in ONE batched receive. Per-channel
anti-re-decode arming follows the reference's frames_to_read arithmetic
(arq_common.cc:2690-2730). Batch shapes are bucketed to powers of two, as
in the JAX pool.

    pool = StreamPool(build_geometry(9), n_channels=1024)
    pool.feed(ch, chunk)            # any chunk size, per channel
    pool.feed_block(chunk_block)    # or all channels at once, one call
    for ch, res in pool.step():     # one batched dispatch for all ready
        if res.crc_ok: ...

DeviceStreamPool and FusedDevicePool keep the windows on the card as one
[C, window_len] float32 tensor. The three share one core (`_Pool`) and
one re-arm rule (`rearm`; IDLE_REARM symbols after a decode that delivered
no frame), and the two unfused pools their step's tail (`_decode_ready`).
Every pool runs its chain on the CUDA card unless `device` (or the `rx`
chain given) names another; host data moves through pinned memory, and
each step or round reads its results back in one copy (FusedDevicePool: of
the JAX pool's packed uint8 block). Per-channel results are `RxResult`s of
numpy rows, as the JAX pools return.
"""

from __future__ import annotations

import gc
from dataclasses import fields

import numpy as np
import torch

from mercury_tpu_torch import obs
from mercury_tpu_torch.convert import host_rows
from mercury_tpu_torch.core.geometry import ModeGeometry
from mercury_tpu_torch.modem.rx import RxChain, RxResult
from mercury_tpu_torch.runtime import WindowPool

# the packed scalar columns after payload and ok, 4 bytes each (the JAX
# FusedDevicePool's bitcast layout, little-endian)
_SCALARS = (("delay", torch.int32), ("freq_offset", torch.float32),
            ("snr_db", torch.float32), ("iters", torch.int32),
            ("sync_metric", torch.float32))
# RxResult's fields on the host, in its order, as the JAX pools return them
_HOST_DTYPES = (np.uint8, bool, np.int32, np.float32, np.float32, np.int32,
                np.float32, np.float32)
# symbols a channel waits after a decode that delivered no frame
IDLE_REARM = 4


def _pack(res: RxResult, ok: torch.Tensor) -> torch.Tensor:
    """Results -> one uint8 [B, frame_bytes + 21] block: payload, ok, then
    each scalar's 4 bytes (.view(torch.uint8) on a contiguous int32/float32
    column)."""
    cols = [res.payload.to(torch.uint8), ok.to(torch.uint8)[:, None]]
    for name, dt in _SCALARS:
        x = getattr(res, name).to(dt).contiguous()
        cols.append(x.view(torch.uint8).reshape(-1, 4))
    return torch.cat(cols, dim=-1)


def _columns(flat: np.ndarray, frame_bytes: int) -> tuple:
    """Host [B, frame_bytes + 21] uint8 block -> (payload, ok, delay, freq,
    snr, iters, metric) numpy columns."""
    flat = np.ascontiguousarray(flat)
    cols = [flat[:, :frame_bytes], flat[:, frame_bytes].astype(bool)]
    off = frame_bytes + 1
    for i, (_name, dt) in enumerate(_SCALARS):
        cols.append(flat[:, off + 4 * i: off + 4 * i + 4]
                    .view(_HOST_DTYPES[2 + i])[:, 0])
    return tuple(cols)


def _results(chans: np.ndarray, cols) -> list[tuple[int, RxResult]]:
    """(channel, one-row RxResult) pairs of the rows whose ok column is
    set, in row order. cols: RxResult's fields as host columns of the rows
    ([R] or [R, frame_bytes] each, in its order; without mean_h it reads
    0), chans [R] the rows' channels. A result's fields are [1] or
    [1, frame_bytes] rows of the columns (of a copy of the ok rows where
    some are not ok), split in C; no two results share memory. The cyclic
    collector is paused while the results are made (each result and pair
    is a tracked object, so thousands of them set off collections) and
    left as it was found."""
    keep = np.flatnonzero(cols[1])
    n = len(keep)
    if n < len(chans):
        chans = chans[keep]
        cols = [c[keep] for c in cols]
    if len(cols) < len(_HOST_DTYPES):
        cols = [*cols, np.zeros(n, np.float32)]
    collecting = gc.isenabled()
    gc.disable()
    try:
        rows = [list(c.reshape(n, 1, *c.shape[1:])) for c in cols]
        return list(zip(chans.tolist(), map(RxResult, *rows)))
    finally:
        if collecting:
            gc.enable()


def _to_device(host, device: torch.device, stream=None) -> torch.Tensor:
    """float32 host array -> device tensor: on the card, staged in pinned
    memory and copied with non_blocking=True (on `stream` if given). A
    tensor (capture that arrives on the card) is moved with .to(), a no-op
    where it already lies on `device`."""
    if torch.is_tensor(host):
        return host.to(device, torch.float32)
    t = torch.from_numpy(np.ascontiguousarray(host, dtype=np.float32))
    if device.type != "cuda":
        return t.to(device)
    t = t.pin_memory()
    if stream is None:
        return t.to(device, non_blocking=True)
    with torch.cuda.stream(stream):
        return t.to(device, non_blocking=True)


def _roll(windows: torch.Tensor, chunk: torch.Tensor,
          spare: torch.Tensor) -> torch.Tensor:
    """The windows moved left by the chunk's length with the chunk at the
    end, written by one torch.cat into `spare` (the caller swaps the two
    buffers; an in-place overlapping copy would be undefined)."""
    n = chunk.shape[-1]
    return torch.cat([windows[:, n:], chunk], dim=-1, out=spare)


def rearm(ok: torch.Tensor, delay: torch.Tensor, sym_len: int,
          frame_syms: int) -> torch.Tensor:
    """Each decoded channel's frames_to_read (arq_common.cc:2690-2730): past
    the frame it delivered (ok), else IDLE_REARM symbols; at least 1."""
    return torch.clamp(torch.where(
        ok, torch.div(delay, sym_len, rounding_mode="floor") + frame_syms,
        IDLE_REARM), min=1)


def _bucket(n: int, cap: int) -> int:
    """n rounded up to a power of two (as the JAX pools bound their
    compiled shapes), at most cap."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class _Pool:
    """The pools' shared core: the geometry, the chain (`rx`, else one built
    on `device`) and its device, the lengths and the counters."""

    def __init__(self, geom: ModeGeometry, n_channels: int,
                 rx: RxChain | None = None, device=None):
        self.geom = geom
        self.rx = rx or RxChain(geom, device=device)
        self.device = self.rx.device
        self.buf_len = geom.nofdm * geom.buffer_nsymb * geom.interp
        self.sym_len = geom.nofdm * geom.interp
        self.frame_syms = geom.nsymb + geom.preamble_nsymb
        self.n_channels = n_channels
        self.frames_decoded = 0
        self.batched_dispatches = 0


def _decode_ready(pool, rows: torch.Tensor,
                  chans: np.ndarray) -> tuple[list, np.ndarray]:
    """The unfused pools' step after the gather: one receive of rows (the
    ready channels chans, then padding) and one host copy of their fields
    and re-arm values. -> ((channel, RxResult) pairs, frames_to_read)."""
    r = len(chans)
    res = pool.rx.receive(rows)
    pool.batched_dispatches += 1
    pool.rows_dispatched += r
    host = host_rows(*(getattr(res, f.name)[:r] for f in fields(res)),
                     rearm(res.crc_ok[:r], res.delay[:r], pool.sym_len,
                           pool.frame_syms))
    fb = res.payload.shape[1]
    cols = [host[:, :fb].astype(np.uint8)] + [
        host[:, fb + i].astype(dt) for i, dt in enumerate(_HOST_DTYPES[1:])]
    out = _results(chans, cols)
    pool.frames_decoded += len(out)
    return out, host[:, -1].astype(np.int64)


class DeviceStreamPool(_Pool):
    """Device-resident serving pool: the per-channel windows live on the
    card as one [C, window_len] float32 tensor.

    StreamPool moves the full [R, window] rows host->device every step.
    For uniform-block serving (aggregated SDR front-ends delivering one
    [C, chunk] block per tick), this pool keeps the window state on the
    device: feed_block uploads ONLY the new chunk (from pinned memory,
    non_blocking) and rolls the windows with one torch.cat into a second
    buffer that is swapped in; step() decodes a bucket of ready rows
    gathered on the card (index_select). Countdown/arming bookkeeping
    (scalars per channel) stays on the host, mirroring the capture-prep
    protocol (reference audioio.c:999-1069 / arq_common.cc:2690-2730).

    Requires every feed_block to carry a whole number of symbols (the
    ragged/partial-symbol case is StreamPool's job).
    """

    def __init__(self, geom: ModeGeometry, n_channels: int,
                 rx: RxChain | None = None, device=None):
        super().__init__(geom, n_channels, rx, device)
        self.windows = torch.zeros((n_channels, self.buf_len),
                                   dtype=torch.float32, device=self.device)
        self._spare = torch.empty_like(self.windows)
        self._ftr = np.full(n_channels, geom.buffer_nsymb, np.int64)
        self._ready = np.zeros(n_channels, bool)
        self.rows_dispatched = 0

    def feed_block(self, block: np.ndarray) -> None:
        """One [n_channels, k*sym_len] capture block -> single H2D upload
        + the window roll on the card; countdown advances k symbols."""
        assert block.shape[0] == self.n_channels
        assert block.shape[1] % self.sym_len == 0, \
            "DeviceStreamPool feeds whole symbols (use StreamPool for ragged)"
        k = block.shape[1] // self.sym_len
        chunk = _to_device(block, self.device)
        self.windows, self._spare = (
            _roll(self.windows, chunk, self._spare), self.windows)
        self._ready |= self._ftr <= k
        self._ftr = np.maximum(self._ftr - k, 0)

    def step(self) -> list[tuple[int, RxResult]]:
        chans = np.flatnonzero(self._ready)
        r = len(chans)
        if r == 0:
            return []
        idx = np.zeros(_bucket(r, self.n_channels), np.int64)
        idx[:r] = chans
        rows = torch.index_select(
            self.windows, 0, torch.from_numpy(idx).to(self.device))
        out, self._ftr[chans] = _decode_ready(self, rows, chans)
        self._ready[chans] = False
        return out


class FusedDevicePool(_Pool):
    """Serving pool with ONE dispatch sequence and ONE D2H per round.

    The budget has three line items a bench can measure and sum:

      1. H2D: the new chunk (the information-theoretic minimum ingest)
      2. one round on the card: window roll + full-batch receive +
         frames_to_read arming as tensor ops (the reference capture-prep
         countdown, audioio.c:999-1069 / arq_common.cc:2690-2730 — an
         int32 vector on the card)
      3. one packed D2H: payload bytes + crc + delay + freq + snr + iters
         + sync metric, the scalars' bytes viewed as uint8, one row per
         channel: byte for byte the JAX pool's layout

    Differences vs DeviceStreamPool: every channel is decoded every round
    (no gather/bucketing — in lockstep uniform-block serving all channels
    are ready each round anyway); non-ready rows are decoded and masked.
    next_block (double buffering) uploads round r+1's chunk on a side CUDA
    stream as soon as round r has taken its own, before its receive is
    issued, so the upload runs under the round's kernels; the next round
    waits on its event before it reads the chunk.
    """

    def __init__(self, geom: ModeGeometry, n_channels: int,
                 rx: RxChain | None = None, device=None):
        super().__init__(geom, n_channels, rx, device)
        self.frame_bytes = geom.frame_bytes
        self.windows = torch.zeros((n_channels, self.buf_len),
                                   dtype=torch.float32, device=self.device)
        self._spare = torch.empty_like(self.windows)
        self.ftr = torch.full((n_channels,), geom.buffer_nsymb,
                              dtype=torch.int32, device=self.device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._pending = None
        self.prefetched_rounds = 0      # rounds whose chunk a prefetch gave

    def prefetch(self, block: np.ndarray) -> None:
        """Start uploading the NEXT round's chunk (double buffering), on
        the side stream when on the card."""
        chunk = _to_device(block, self.device, self._copy_stream)
        event = None
        if self._copy_stream is not None:
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._pending = (chunk, event)

    def _chunk(self, block: np.ndarray) -> torch.Tensor:
        if self._pending is None:
            return _to_device(block, self.device)
        chunk, event = self._pending
        self._pending = None
        self.prefetched_rounds += 1
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            chunk.record_stream(stream)
        return chunk

    @torch.no_grad()
    def round(self, block, next_block: np.ndarray = None):
        """One serving round of a [C, k*sym_len] block (host numpy, or a
        tensor already on the card). Returns the packed on-device result
        tensor [C, frame_bytes+21] uint8; unpack() reads it to host in one
        D2H."""
        assert block.shape[0] == self.n_channels
        assert block.shape[1] % self.sym_len == 0, \
            "FusedDevicePool feeds whole symbols"
        chunk = self._chunk(block)
        if next_block is not None:
            # the next upload runs on the side stream under this round
            self.prefetch(next_block)
        n = chunk.shape[-1]
        k = n // self.sym_len
        self.windows, self._spare = (
            _roll(self.windows, chunk, self._spare), self.windows)
        ready = self.ftr <= k
        res = self.rx.receive(self.windows)
        ok = res.crc_ok & ready
        self.ftr = torch.where(
            ready, rearm(ok, res.delay, self.sym_len, self.frame_syms),
            torch.clamp(self.ftr - k, min=0)).to(torch.int32)
        packed = _pack(res, ok)
        self.batched_dispatches += 1
        return packed

    def unpack(self, packed: torch.Tensor) -> list[tuple[int, RxResult]]:
        """ONE D2H of the packed result block -> per-channel RxResults."""
        host = packed.cpu().numpy()
        n_ok = int(np.count_nonzero(host[:, self.frame_bytes]))
        with obs.span("pool.unpack.build", n_ok):
            out = _results(np.arange(host.shape[0]),
                           _columns(host, self.frame_bytes))
        self.frames_decoded += len(out)
        return out


class StreamPool(_Pool):
    def __init__(self, geom: ModeGeometry, n_channels: int,
                 rx: RxChain | None = None, device=None):
        super().__init__(geom, n_channels, rx, device)
        self.pool = WindowPool(n_channels, self.buf_len, self.sym_len)
        arm0 = np.full(n_channels, geom.buffer_nsymb, np.int32)
        self.pool.arm_many(np.arange(n_channels, dtype=np.int32), arm0)
        self.rows_dispatched = 0

    def feed(self, channel: int, samples: np.ndarray) -> None:
        """Push capture audio for one channel (any chunk size; partial
        symbols are staged natively until a full symbol accumulates)."""
        self.pool.feed(channel, samples)

    def feed_block(self, block: np.ndarray) -> None:
        """Push one [n_channels, n] block of capture audio — a single
        native call for the whole pool tick."""
        self.pool.feed_block(block)

    def step(self) -> list[tuple[int, RxResult]]:
        """Decode every channel whose window countdown elapsed, in ONE
        batched receive (rows padded with zero rows to a power-of-two
        bucket, as the JAX pool bounds its compiled shapes; the rows go to
        the card in one pinned-memory copy). Returns (channel, single-row
        RxResult) pairs for channels that decoded a frame; non-decoding
        ready channels are re-armed IDLE_REARM symbols ahead."""
        rows, chans = self.pool.gather_ready()
        r = len(chans)
        if r == 0:
            return []
        bucket = _bucket(r, self.n_channels)
        if bucket > r:
            rows = np.concatenate(
                [rows, np.zeros((bucket - r, self.buf_len), np.float32)])
        out, ftr = _decode_ready(self, _to_device(rows, self.device), chans)
        self.pool.arm_many(chans, ftr)
        return out
