"""Two-node ARQ simulation over the channel model with a simulated clock.

Replaces the reference's VB-Audio-Cable loopback integration tests
(tools/robust_loopback_test.py, throughput_test.py) with a deterministic
in-process harness: transmissions occupy simulated air-time, the channel adds
AWGN/CFO, and both nodes' timers run on the same simulated clock — a full
ARQ session runs in seconds of wall time.

PyTorch port of the JAX package's `link/sim.py`: the channel is host numpy
(the port's `channel.sim` fading process, analytic signal and, on a CPU
tensor, `apply_cfo`), so the simulator never touches the card; the nodes'
chains run where their `device` puts them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mercury_tpu_torch.channel import sim as csim
from mercury_tpu_torch.link import protocol as P
from mercury_tpu_torch.link.node import ArqNode


@dataclass
class ChannelModel:
    snr_db: float | None = None      # None = clean
    cfo_hz: float = 0.0
    seed: int = 0
    drop_blocks: tuple = ()          # block indices the channel swallows
    snr_schedule: object = None      # callable sim_time_s -> snr_db | None
                                     # (overrides snr_db; noise-burst stress)
    mutilate: object = None          # callable (block_idx, samples)->samples:
                                     # surgical per-frame corruption injection
    fading: str | None = None        # Watterson preset name ("good"/
                                     # "moderate"/"poor"): a CONTINUOUS
                                     # two-path Rayleigh process sampled at
                                     # the block's simulated-time position,
                                     # so fades persist across blocks/ACKs
                                     # (what the gearshift actually faces)
    fading_horizon_s: float = 1800.0  # tap-process length (simulated time)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._block_counter = 0
        self.now_s = 0.0             # set by the simulator before apply()
        self.src = None              # transmitting node, set by the simulator
        if self.fading is not None:
            p = csim.WATTERSON_PRESETS[self.fading]
            self._fad_delay_s = p["delay_ms"] * 1e-3
            fs_low = max(p["doppler_hz"] * 64.0, 8.0)
            n_low = int(np.ceil(self.fading_horizon_s * fs_low)) + 2
            rng_f = np.random.default_rng(self.seed + 104729)
            self._fad_t_low = np.arange(n_low) / fs_low
            self._fad_h = [
                csim._fading_process(n_low, fs_low, p["doppler_hz"], rng_f)
                / np.sqrt(2.0)
                for _ in range(2)]

    def apply(self, samples: np.ndarray) -> np.ndarray:
        idx = self._block_counter
        self._block_counter += 1
        if self.snr_schedule is not None:
            self.snr_db = self.snr_schedule(self.now_s)
        if idx in self.drop_blocks:
            return np.zeros_like(samples, dtype=np.float32)
        if self.mutilate is not None:
            samples = self.mutilate(idx, samples)
        out = samples.astype(np.float64)
        # mean TX power BEFORE fading: the SNR parameter means the *mean*
        # channel SNR — a deep fade must lower the instantaneous SNR, not
        # re-normalize the noise
        p_clean = np.mean(out ** 2)
        if self.fading is not None:
            fs = 48000.0
            n = len(out)
            t = self.now_s + np.arange(n) / fs
            h0 = (np.interp(t, self._fad_t_low, self._fad_h[0].real)
                  + 1j * np.interp(t, self._fad_t_low, self._fad_h[0].imag))
            h1 = (np.interp(t, self._fad_t_low, self._fad_h[1].real)
                  + 1j * np.interp(t, self._fad_t_low, self._fad_h[1].imag))
            xa = csim._hilbert(out)
            d = int(round(self._fad_delay_s * fs))
            delayed = np.concatenate([np.zeros(d, complex), xa[: n - d]])
            out = np.real(h0 * xa + h1 * delayed)
        if self.cfo_hz:
            out = csim.apply_cfo(torch.from_numpy(out[None]), 48000.0,
                                 1471.875, self.cfo_hz)[0].numpy()
        if self.snr_db is not None:
            f_nyq = 24000.0
            sigma = np.sqrt(2.0 * p_clean * f_nyq /
                            (10 ** (self.snr_db / 10.0) * 2343.75)) / np.sqrt(2.0)
            out = out + sigma * self._rng.standard_normal(len(out))
        return out.astype(np.float32)


class LinkSimulator:
    """Drives a commander/responder pair through the channel."""

    def __init__(self, commander: ArqNode, responder: ArqNode,
                 channel: ChannelModel | None = None,
                 turnaround_ms: float = 300.0):
        self.a, self.b = commander, responder
        self.channel = channel or ChannelModel()
        self.turnaround_ms = turnaround_ms
        self.now = 0.0
        self.log: list[tuple[float, str, str]] = []

    def _deliver(self, src: ArqNode, dst: ArqNode, block: np.ndarray) -> None:
        duration_ms = 1000.0 * len(block) / 48000.0
        self.channel.now_s = self.now / 1000.0
        self.channel.src = src
        rx = self.channel.apply(block)
        self.now += duration_ms + self.turnaround_ms
        dst.on_samples(rx, self.now)

    def run(self, max_sim_s: float = 600.0, until=None) -> float:
        """Run until `until()` is truthy or simulated time expires.
        Returns elapsed simulated seconds."""
        idle_quantum = 200.0
        start = self.now
        while (self.now - start) < max_sim_s * 1000.0:
            if until is not None and until():
                break
            progressed = False
            for src, dst in ((self.a, self.b), (self.b, self.a)):
                for block in src.poll(self.now):
                    self._deliver(src, dst, block)
                    progressed = True
            if not progressed:
                self.now += idle_quantum
            if self.a.link_status == P.DROPPED or self.b.link_status == P.DROPPED:
                break
        return (self.now - start) / 1000.0
