"""The program's own spans (`mercury_tpu_torch.obs`) over a run's traced
stretch, on the trace's clock.

The program records its spans while torch.profiler records, on the host's
`time.perf_counter` clock, the clock of the harness's round stamps. The
harness maps those stamps onto the device trace by one shift (the first
traced round's call onto the trace's first runtime call); the same shift
puts every span on the trace's clock, so a device-idle gap can be placed
inside the host span that covers it. A checkout whose program has no
recorder, or a run without a trace, gives None, and the metric is left
out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Stretch:
    """The spans that lie wholly in [trace.lo, trace.hi], times in the
    trace's microseconds."""
    name: np.ndarray
    start: np.ndarray
    end: np.ndarray
    n: np.ndarray
    device_ms: np.ndarray | None    # NaN where a span has no device time
    rounds: int

    def of(self, name: str) -> np.ndarray:
        return self.name == name

    def host_ms(self, name: str) -> float:
        """Host ms of `name`'s spans a round (0 where none ran)."""
        m = self.of(name)
        return float((self.end[m] - self.start[m]).sum()) * 1e-3 / self.rounds

    def count(self, name: str) -> float:
        """The n of `name`'s spans summed, a round."""
        return float(self.n[self.of(name)].sum()) / self.rounds

    def device_ms_of(self, name: str) -> float | None:
        """The card's ms of `name`'s spans a round, or None when none of
        them has a device time."""
        if self.device_ms is None:
            return None
        ms = self.device_ms[self.of(name)]
        ms = ms[~np.isnan(ms)]
        return float(ms.sum()) / self.rounds if ms.size else None


def recorded() -> dict | None:
    """The program's recorded spans (`obs.spans()`), or None where the
    program has no recorder."""
    try:
        from mercury_tpu_torch import obs
    except ImportError:
        return None
    read = getattr(obs, "spans", None)
    return read() if read is not None else None


def shift_us(run) -> float:
    """Trace microseconds minus host seconds x 1e6, as the harness mapped
    the traced rounds."""
    tr = run.trace
    return tr.phases[0][0] - run.rounds[-tr.rounds][0] * 1e6


def stretch(run) -> Stretch | None:
    """The run's spans in its traced stretch, or None without a trace, a
    recorder or any span there."""
    tr = run.trace
    if tr is None or not tr.rounds:
        return None
    s = recorded()
    if s is None:
        return None
    shift = shift_us(run)
    start = s["start_ns"] * 1e-3 + shift
    end = s["end_ns"] * 1e-3 + shift
    keep = (start >= tr.lo) & (end <= tr.hi)
    if not keep.any():
        return None
    dev = s["device_ms"]
    return Stretch(np.asarray(s["name"])[keep], start[keep], end[keep],
                   np.asarray(s["n"])[keep],
                   None if dev is None else np.asarray(dev)[keep], tr.rounds)
