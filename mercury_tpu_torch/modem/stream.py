"""Streaming receiver: continuous capture -> decoded frames (PyTorch port
of the JAX package's `modem/stream.py`).

The host runtime's sliding capture window (`runtime.SlidingWindow`) feeds
batch-1 receives on the chain's device (the reference's capture-prep thread
and receive() loop, audioio.c:999-1069 / arq_common.cc:2607-2897, as a
pull-driven object).

    rx = StreamReceiver(build_geometry(9))      # on the card
    for chunk in audio_source:                  # any chunk size
        for result in rx.feed(chunk):
            if result.crc_ok: ...
"""

from __future__ import annotations

import numpy as np
import torch

from mercury_tpu_torch.core.geometry import ModeGeometry
from mercury_tpu_torch.modem.rx import RxChain, RxResult
from mercury_tpu_torch.runtime import SlidingWindow


class StreamReceiver:
    """rx: the chain to receive with; without one, an RxChain of geom on
    `device` (the card unless given)."""

    def __init__(self, geom: ModeGeometry, rx: RxChain | None = None,
                 metric_gate: float = 0.5, device=None):
        self.geom = geom
        self.rx = rx or RxChain(geom, device=device)
        g = geom
        self.buf_len = g.nofdm * g.buffer_nsymb * g.interp
        self.sym_len = g.nofdm * g.interp
        self.frame_syms = g.nsymb + g.preamble_nsymb
        self.metric_gate = metric_gate
        self.window = SlidingWindow(self.buf_len, self.sym_len)
        self.window.arm(g.buffer_nsymb)
        self._frames_decoded = 0
        self._residual = np.zeros(0, np.float32)

    def _receive(self, work: np.ndarray) -> tuple[RxResult, bool, int]:
        """One batch-1 receive -> (result, crc_ok, delay), the two read
        with one copy to the host."""
        res = self.rx.receive(work[None])
        ok, delay = torch.cat([res.crc_ok.to(torch.int32),
                               res.delay]).cpu().tolist()
        return res, bool(ok), int(delay)

    def feed(self, samples: np.ndarray) -> list[RxResult]:
        """Push capture audio (any chunk size); returns decode results for
        every frame found. Only full symbol-sized pieces are pushed (the
        window countdown advances one per push, reference audioio.c capture
        callback delivers whole symbols) — a sub-symbol tail is held until
        the next call."""
        out: list[RxResult] = []
        self._residual = np.concatenate(
            [self._residual, np.asarray(samples, np.float32)])
        n_full = len(self._residual) // self.sym_len * self.sym_len
        samples, self._residual = (
            self._residual[:n_full], self._residual[n_full:])
        for pos in range(0, len(samples), self.sym_len):
            self.window.push(samples[pos: pos + self.sym_len])
            if not self.window.ready:
                continue
            snap, _ = self.window.snapshot()
            # iterative cancellation: a window can hold several complete
            # frames and the sync returns its best one (not necessarily the
            # earliest) — zero each decoded frame and re-run until nothing
            # more decodes, then deliver in time order
            found = []
            work = snap.copy()
            for _ in range(max(self.buf_len // (self.frame_syms * self.sym_len), 1) + 1):
                res, ok, delay = self._receive(work)
                if not ok:
                    break
                found.append((delay, res))
                work[delay: delay + self.frame_syms * self.sym_len] = 0.0
            if found:
                found.sort(key=lambda f: f[0])
                out.extend(res for _delay, res in found)
                self._frames_decoded += len(found)
                # skip past the last decoded frame (anti-re-decode,
                # reference arq_common.cc:2690-2730)
                last_delay = found[-1][0]
                consumed = (last_delay // self.sym_len) + self.frame_syms
                self.window.arm(max(consumed, 1))
            else:
                # no decode: slide a few symbols and try again
                self.window.arm(4)
        return out

    def reset(self) -> None:
        self.window.clear()
        self.window.arm(self.geom.buffer_nsymb)
        self._residual = np.zeros(0, np.float32)
