"""Bit-exact reimplementation of the glibc TYPE_3 ``random()`` generator.

Mercury embeds a copy of glibc's additive-feedback generator (trinomial
x^31 + x^3 + 1) and seeds every deterministic sequence with it: the pilot
sequence (seed 0), the preamble sequence (seed 1), the bit-energy-dispersal
sequence (seed 0), and BER test payloads.  Bit-exact payload parity with the
reference therefore requires this exact generator
(reference: source/common/os_interop.cc:151-415).

This runs on host only, at geometry-build time; nothing here touches the device.
"""

from __future__ import annotations

import numpy as np

_DEG = 31
_SEP = 3


class GlibcRandom:
    """glibc random() (TYPE_3): additive feedback r[i] = r[i-3] + r[i-31]."""

    def __init__(self, seed: int):
        self.srandom(seed)

    def srandom(self, seed: int) -> None:
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        state = np.zeros(_DEG, dtype=np.int64)
        state[0] = np.int32(seed)
        # Park-Miller LCG fills the state table (word = 16807*word mod 2^31-1,
        # computed via Schrage's method exactly as glibc does).
        word = int(np.int32(seed))
        for i in range(1, _DEG):
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            state[i] = word
        self._state = state.astype(np.uint32)
        self._f = _SEP  # front pointer index
        self._r = 0     # rear pointer index
        # Warm-up: discard 10*degree outputs.
        self.draw(_DEG * 10)

    def _next(self) -> int:
        s = self._state
        val = (int(s[self._f]) + int(s[self._r])) & 0xFFFFFFFF
        s[self._f] = val
        self._f += 1
        if self._f >= _DEG:
            self._f = 0
            self._r += 1
        else:
            self._r += 1
            if self._r >= _DEG:
                self._r = 0
        return val >> 1

    def draw(self, n: int) -> np.ndarray:
        """Return the next n outputs of random() as int64."""
        out = np.empty(n, dtype=np.int64)
        for i in range(n):
            out[i] = self._next()
        return out

    def bits(self, n: int) -> np.ndarray:
        """Next n outputs of random() % 2 (int8)."""
        return (self.draw(n) % 2).astype(np.int8)
