"""The frozen transmitter against the port's tables and transmitter, and
the port's serving pool judged by it on a tiny clean case (CPU)."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, traffic, txref
from mercury_tpu_torch.core import crc
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.core.prng import GlibcRandom
from mercury_tpu_torch.modem.tx import TxChain

MODES = {9: dict(constellation_points=4, pilot_density="high",
                 preamble_nsymb=4, ldpc_rate_num=8),
         16: dict(constellation_points=32, pilot_density="high",
                  preamble_nsymb=1, ldpc_rate_num=14)}


def test_prng_and_crc():
    for seed in (0, 1, 77):
        assert np.array_equal(GlibcRandom(seed).bits(3000),
                              txref.glibc_random_bits(seed, 3000))
    p = np.random.default_rng(3).integers(0, 256, (4, 98)).astype(np.uint8)
    assert txref.crc16(torch.as_tensor(p)).tolist() == [crc.crc16(r)
                                                         for r in p]


@pytest.mark.parametrize("cfg", [9, 16])
def test_frames_equal_the_ports(cfg):
    mode = txref.build_mode(MODES[cfg])
    g = build_geometry(cfg)
    assert (mode.frame_bytes, mode.frame_len) == (g.frame_bytes,
                                                  g.total_frame_size)
    assert traffic.buffer_symbols(mode) == g.buffer_nsymb
    pay = torch.as_tensor(np.random.default_rng(cfg).integers(
        0, 256, (3, g.frame_bytes)).astype(np.uint8))
    want = TxChain(g, device="cpu", dtype=torch.float64).transmit(pay)
    got = txref.transmit(mode, pay)
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < 1e-6


def test_cell_files_match_their_modes():
    for w in harness.load_spec()["workloads"]:
        cell = harness.load_cell(w["name"])
        mode = txref.build_mode(cell["mode"])
        assert mode.frame_bytes == cell["mode"]["frame_bytes"]
        lead = cell["lead_symbols"]
        assert cell["chunk_symbols"] == traffic.least_chunk_symbols(mode, lead)
        assert cell["ring_pinned_bytes"] == 4 * cell["ring_blocks"] * \
            cell["channels"] * cell["chunk_symbols"] * mode.sym_len


def test_ring_is_the_seeds():
    cell = harness.load_cell("c9_pool4096_clean")
    cell.update(channels=2, ring_blocks=2)
    mode = txref.build_mode(cell["mode"])
    a = traffic.build_ring(mode, cell, 2 ** 33 + 1, torch.device("cpu"))
    b = traffic.build_ring(mode, cell, 2 ** 33 + 1, torch.device("cpu"))
    c = traffic.build_ring(mode, cell, 2 ** 33 + 2, torch.device("cpu"))
    assert torch.equal(a.blocks, b.blocks)
    assert np.array_equal(a.payloads, b.payloads)
    assert not np.array_equal(a.payloads, c.payloads)
    assert not np.array_equal(a.payloads[0], a.payloads[1])


def test_clean_pool_delivers_what_was_sent():
    """The port's pool on the frozen frames at 12 dB: every frame of every
    round delivered with the bytes sent."""
    cell = harness.load_cell("c9_pool4096_clean")
    cell.update(channels=3, ring_blocks=3, kept_every=1)
    run, checks = harness.serve(cell, 41, 0.5, False, torch.device("cpu"),
                                time.perf_counter(), {})
    assert checks["missed_share"]["value"] == 0
    assert checks["wrong_share"]["value"] == 0
    assert checks["wrong_share"]["checked"] == 3 * len(run.rounds)
