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
[C, window_len] float32 tensor. Every pool runs its chain on the CUDA card
unless `device` (or the `rx` chain given) names another; host data moves
through pinned memory, and each step or round reads its results back in one
copy (FusedDevicePool: of the JAX pool's packed uint8 block). Per-channel results are `RxResult`s of numpy
rows, as the JAX pools return.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

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


def _host_fields(res: RxResult, r: int) -> list[np.ndarray]:
    """The first r rows of every RxResult field -> numpy columns of the
    JAX pools' types, read with one host copy."""
    host = host_rows(*(getattr(res, f.name)[:r] for f in fields(res)))
    fb = res.payload.shape[1]
    return [host[:, :fb].astype(np.uint8)] + [
        host[:, fb + i].astype(dt) for i, dt in enumerate(_HOST_DTYPES[1:])]


def _to_device(host: np.ndarray, device: torch.device,
               stream=None) -> torch.Tensor:
    """float32 host array -> device tensor: on the card, staged in pinned
    memory and copied with non_blocking=True (on `stream` if given)."""
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


class DeviceStreamPool:
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
                 rx: RxChain | None = None, idle_rearm: int = 4,
                 device=None):
        self.geom = geom
        self.rx = rx or RxChain(geom, device=device)
        self.device = self.rx.device
        g = geom
        self.buf_len = g.nofdm * g.buffer_nsymb * g.interp
        self.sym_len = g.nofdm * g.interp
        self.frame_syms = g.nsymb + g.preamble_nsymb
        self.n_channels = n_channels
        self.idle_rearm = idle_rearm
        self.windows = torch.zeros((n_channels, self.buf_len),
                                   dtype=torch.float32, device=self.device)
        self._spare = torch.empty_like(self.windows)
        self._ftr = np.full(n_channels, g.buffer_nsymb, np.int64)
        self._ready = np.zeros(n_channels, bool)
        self.frames_decoded = 0
        self.batched_dispatches = 0
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
        bucket = min(StreamPool._bucket(r), self.n_channels)
        idx = np.zeros(bucket, np.int64)
        idx[:r] = chans
        rows = torch.index_select(
            self.windows, 0, torch.from_numpy(idx).to(self.device))
        res = self.rx.receive(rows)
        self.batched_dispatches += 1
        self.rows_dispatched += r
        cols = _host_fields(res, r)
        ok, delays = cols[1], cols[2]
        out: list[tuple[int, RxResult]] = []
        for i in range(r):
            c = int(chans[i])
            if ok[i]:
                out.append((c, RxResult(*(f[i: i + 1] for f in cols))))
                self._ftr[c] = max(int(delays[i]) // self.sym_len
                                   + self.frame_syms, 1)
            else:
                self._ftr[c] = self.idle_rearm
            self._ready[c] = False
        self.frames_decoded += len(out)
        return out


class FusedDevicePool:
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
    stream right after round r is issued; the next round waits on its
    event before it reads the chunk.
    """

    def __init__(self, geom: ModeGeometry, n_channels: int,
                 rx: RxChain | None = None, idle_rearm: int = 4,
                 device=None):
        self.geom = geom
        self.rx = rx or RxChain(geom, device=device)
        self.device = self.rx.device
        g = geom
        self.buf_len = g.nofdm * g.buffer_nsymb * g.interp
        self.sym_len = g.nofdm * g.interp
        self.frame_syms = g.nsymb + g.preamble_nsymb
        self.n_channels = n_channels
        self.idle_rearm = idle_rearm
        self.frame_bytes = g.frame_bytes
        self.windows = torch.zeros((n_channels, self.buf_len),
                                   dtype=torch.float32, device=self.device)
        self._spare = torch.empty_like(self.windows)
        self.ftr = torch.full((n_channels,), g.buffer_nsymb,
                              dtype=torch.int32, device=self.device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._pending = None
        self.frames_decoded = 0
        self.batched_dispatches = 0

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
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            chunk.record_stream(stream)
        return chunk

    @torch.no_grad()
    def round(self, block: np.ndarray, next_block: np.ndarray = None):
        """One serving round. Returns the packed on-device result tensor
        [C, frame_bytes+21] uint8; unpack() reads it to host in one D2H."""
        assert block.shape[0] == self.n_channels
        assert block.shape[1] % self.sym_len == 0, \
            "FusedDevicePool feeds whole symbols"
        chunk = self._chunk(block)
        n = chunk.shape[-1]
        k = n // self.sym_len
        self.windows, self._spare = (
            _roll(self.windows, chunk, self._spare), self.windows)
        ready = self.ftr <= k
        res = self.rx.receive(self.windows)
        ok = res.crc_ok & ready
        rearm = torch.where(
            ok, torch.div(res.delay, self.sym_len, rounding_mode="floor")
            + self.frame_syms, self.idle_rearm)
        self.ftr = torch.where(ready, torch.clamp(rearm, min=1),
                               torch.clamp(self.ftr - k, min=0)
                               ).to(torch.int32)
        packed = _pack(res, ok)
        self.batched_dispatches += 1
        if next_block is not None:
            # issue the next upload while the round's kernels run
            self.prefetch(next_block)
        return packed

    def unpack(self, packed: torch.Tensor) -> list[tuple[int, RxResult]]:
        """ONE D2H of the packed result block -> per-channel RxResults."""
        payload, ok, delay, freq, snr, iters, metric = _columns(
            packed.cpu().numpy(), self.frame_bytes)
        out = []
        for c in np.flatnonzero(ok):
            i = int(c)
            out.append((i, RxResult(
                payload[i: i + 1], ok[i: i + 1], delay[i: i + 1],
                freq[i: i + 1], snr[i: i + 1], iters[i: i + 1],
                metric[i: i + 1], np.zeros(1, np.float32))))
        self.frames_decoded += len(out)
        return out


class StreamPool:
    def __init__(self, geom: ModeGeometry, n_channels: int,
                 rx: RxChain | None = None, idle_rearm: int = 4,
                 device=None):
        self.geom = geom
        self.rx = rx or RxChain(geom, device=device)
        self.device = self.rx.device
        g = geom
        self.buf_len = g.nofdm * g.buffer_nsymb * g.interp
        self.sym_len = g.nofdm * g.interp
        self.frame_syms = g.nsymb + g.preamble_nsymb
        self.n_channels = n_channels
        self.idle_rearm = idle_rearm
        self.pool = WindowPool(n_channels, self.buf_len, self.sym_len)
        arm0 = np.full(n_channels, g.buffer_nsymb, np.int32)
        self.pool.arm_many(np.arange(n_channels, dtype=np.int32), arm0)
        self.frames_decoded = 0
        self.batched_dispatches = 0
        self.rows_dispatched = 0

    def feed(self, channel: int, samples: np.ndarray) -> None:
        """Push capture audio for one channel (any chunk size; partial
        symbols are staged natively until a full symbol accumulates)."""
        self.pool.feed(channel, samples)

    def feed_block(self, block: np.ndarray) -> None:
        """Push one [n_channels, n] block of capture audio — a single
        native call for the whole pool tick."""
        self.pool.feed_block(block)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def step(self) -> list[tuple[int, RxResult]]:
        """Decode every channel whose window countdown elapsed, in ONE
        batched receive (rows padded to a power-of-two bucket, as the JAX
        pool bounds its compiled shapes; the rows go to the card in one
        pinned-memory copy). Returns (channel, single-row RxResult) pairs
        for channels that decoded a frame; non-decoding ready channels are
        re-armed a few symbols ahead."""
        rows, chans = self.pool.gather_ready()
        r = len(chans)
        if r == 0:
            return []
        bucket = min(self._bucket(r), self.n_channels)
        if bucket > r:
            rows = np.concatenate(
                [rows, np.zeros((bucket - r, self.buf_len), np.float32)])
        res = self.rx.receive(_to_device(rows, self.device))
        self.batched_dispatches += 1
        self.rows_dispatched += r
        cols = _host_fields(res, r)
        ok, delays = cols[1], cols[2]
        out: list[tuple[int, RxResult]] = []
        rearm = np.empty(r, np.int32)
        for i in range(r):
            if ok[i]:
                out.append((int(chans[i]),
                            RxResult(*(f[i: i + 1] for f in cols))))
                rearm[i] = max(int(delays[i]) // self.sym_len
                               + self.frame_syms, 1)
            else:
                rearm[i] = self.idle_rearm
        self.frames_decoded += len(out)
        self.pool.arm_many(chans, rearm)
        return out
