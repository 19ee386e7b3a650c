"""The one traffic generator: lockstep serving rounds read from a cell's
file (a frozen copy of the geometry of the port's
`tools/serve_bench._lockstep`).

Every channel carries one frame a round at a fixed lead in its chunk. With
the windows advancing one chunk a round, a frame's position in the window
is stationary at buffer - chunk + lead symbols, and one frame decodes a
round if and only if its re-arm (position + frame) fits in one chunk:
chunk >= (buffer + frame + lead) / 2, and frames do not overlap: chunk >=
frame + lead + 2.

Set-up builds a ring of distinct blocks, each with its own payloads and
noise drawn from the seed on the device, and keeps them in pinned host
memory, as a capture front end hands them over; the measured rounds cycle
through the ring, so no block is synthesized while they run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import txref

TX_ROWS = 1024      # frames the transmitter makes at once (its memory)


def buffer_symbols(mode: txref.Mode) -> int:
    """The receive window in symbols (data_container.cc:133-143)."""
    sym_ms = 1000.0 * (txref.NFFT + txref.NGI) * txref.INTERP / txref.FS
    frame = mode.nsymb + mode.preamble_nsymb
    return max(2 * frame, frame + math.ceil(1200.0 / sym_ms) + 4, 32)


def least_chunk_symbols(mode: txref.Mode, lead: int) -> int:
    frame = mode.nsymb + mode.preamble_nsymb
    return max(frame + lead + 2, -(-(buffer_symbols(mode) + frame + lead) // 2))


@dataclass
class Ring:
    blocks: torch.Tensor        # [L, C, chunk] float32, pinned on a card
    views: list                 # the blocks as numpy arrays (no copy)
    payloads: np.ndarray        # [L, C, frame_bytes] uint8, what each sent
    chunk: int                  # samples a channel a round


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2 ** 63)


def build_ring(mode: txref.Mode, cell: dict, seed: int,
               device: torch.device) -> Ring:
    """cell's ring of blocks: ring_blocks x [channels, chunk] float32,
    frames at lead_symbols, white noise at esn0_db everywhere."""
    lead, chunk_syms = int(cell["lead_symbols"]), int(cell["chunk_symbols"])
    if chunk_syms < least_chunk_symbols(mode, lead):
        raise ValueError(f"chunk_symbols {chunk_syms} is under "
                         f"{least_chunk_symbols(mode, lead)}: frames would "
                         f"not decode one a round")
    n_ch, n_ring = int(cell["channels"]), int(cell["ring_blocks"])
    chunk = chunk_syms * mode.sym_len
    at = lead * mode.sym_len
    sigma = txref.sigma_for_esn0(float(cell["esn0_db"]))
    gen = _generator(seed, device)
    blocks = torch.empty((n_ring, n_ch, chunk), dtype=torch.float32,
                         pin_memory=device.type == "cuda")
    payloads = torch.randint(0, 256, (n_ring, n_ch, mode.frame_bytes),
                             generator=gen, device=device, dtype=torch.uint8)
    for i in range(n_ring):
        blk = sigma * torch.randn((n_ch, chunk), generator=gen, device=device)
        for r in range(0, n_ch, TX_ROWS):
            blk[r:r + TX_ROWS, at:at + mode.frame_len] += txref.transmit(
                mode, payloads[i, r:r + TX_ROWS])
        blocks[i].copy_(blk)
    return Ring(blocks, [b.numpy() for b in blocks], payloads.cpu().numpy(),
                chunk)
