"""ACK/BREAK tone-pattern signaling (PyTorch port of the JAX package's
`modem/patterns.py`; reference telecom_system.cc:1589-1709).

A universal MFSK instance (M=16, 1 stream, inside the 50-carrier band),
the same for every mode, sends 16-symbol Welch-Costas tone patterns: ACK
(p=17, g=5) and BREAK (p=17, g=7). Detection is an energy matched filter
over symbol-aligned windows (`sync.pattern_detect_metric`) of the base-rate
baseband that the mixer and data FIR (`kernels.mix_fir_decimate`, the
strided "same" form) give.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from mercury_tpu_torch.convert import resolve_device
from mercury_tpu_torch.core import hostdsp
from mercury_tpu_torch.core.geometry import ModeGeometry, mfsk_params
from mercury_tpu_torch.dsp import kernels, ops
from mercury_tpu_torch.modem import mfsk, sync

# guards the oscillator cache's fill: the link's nodes share a signaler
# across threads
_CACHE_LOCK = threading.Lock()


class PatternSignaler:
    """TX and detection of the ACK and BREAK patterns of one mode geometry.

    The waveforms are host numpy; detection runs on the CUDA card unless
    `device` names another (device="cpu" for the plain versions; see
    convert.resolve_device)."""

    def __init__(self, geom: ModeGeometry, device=None):
        self.geom = geom
        self.device = resolve_device(device)
        # the same ack MFSK for every mode (telecom_system.cc:3003-3006)
        self.ack_mfsk = mfsk_params(16, geom.nc, 1)
        self.passband_samples = (self.ack_mfsk.ack_pattern_nsymb
                                 * geom.nofdm * geom.interp)
        # per-mode detection threshold (telecom_system.cc:3010-3019)
        self.threshold = 0.65 if geom.spec.config == 100 else 1.0
        self._fir_data = torch.as_tensor(geom.fir_rx_data,
                                         dtype=torch.float32,
                                         device=self.device)
        self._osc_cache: dict = {}

    def _passband(self, tones: np.ndarray) -> np.ndarray:
        """Host synthesis of a pattern's passband waveform."""
        g = self.geom
        grid = mfsk.pattern_grid(self.ack_mfsk, g.nc, tones)
        td = np.concatenate([hostdsp.symbol_mod(row, g.nfft, g.ngi, 1)
                             for row in grid])
        power_norm = np.sqrt(g.nfft * g.interp)
        boost = np.sqrt(g.nc / self.ack_mfsk.nstreams) * 10 ** (-2.0 / 20.0)
        td = td / power_norm * np.sqrt(0.1) * boost
        pb = hostdsp.baseband_to_passband(td, g.fs, g.fc, np.sqrt(2.0),
                                          g.interp, 0)
        return hostdsp.peak_clip(pb, 10.0)

    @functools.cached_property
    def ack_passband(self) -> np.ndarray:
        return self._passband(self.ack_mfsk.ack_tones)

    @functools.cached_property
    def break_passband(self) -> np.ndarray:
        return self._passband(self.ack_mfsk.break_tones)

    def _osc(self, n: int) -> torch.Tensor:
        """The mixer's oscillator table for n samples, built once."""
        osc = self._osc_cache.get(n)
        if osc is None:
            with _CACHE_LOCK:
                osc = self._osc_cache.get(n)
                if osc is None:
                    osc = self._osc_cache[n] = ops.mixer_table(
                        n, self.geom.fc, self.geom.fs, self.device)
        return osc

    @torch.no_grad()
    def _detect(self, pb_buffer, tones: np.ndarray):
        g = self.geom
        pb = torch.as_tensor(pb_buffer).to(device=self.device,
                                           dtype=torch.float32).contiguous()
        bb = kernels.mix_fir_decimate(pb, self._osc(pb.shape[-1]),
                                      self._fir_data, g.interp)
        met, cnt = sync.pattern_detect_metric(bb, g, tones, self.ack_mfsk,
                                              decim=g.interp)
        best = torch.argmax(met, dim=-1, keepdim=True)
        return (torch.gather(met, 1, best)[:, 0],
                torch.gather(cnt, 1, best)[:, 0])

    def detect_ack(self, pb_buffer):
        """pb_buffer [B, n] -> (metric [B], matched symbols [B]) of the best
        symbol-aligned window; detection where metric >= self.threshold (the
        link also asks for at least half the symbols matched, reference
        arq_common.cc:2582-2583)."""
        return self._detect(pb_buffer, self.ack_mfsk.ack_tones)

    def detect_break(self, pb_buffer):
        """As detect_ack, for the BREAK pattern."""
        return self._detect(pb_buffer, self.ack_mfsk.break_tones)
