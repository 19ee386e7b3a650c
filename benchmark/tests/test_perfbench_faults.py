"""`correct` comes out false when the timed path is broken underneath, and
under each cell's control; the harness's look for a card is skipped (CPU,
plain versions, a few channels). The exchange between chips is no fault
these one-card cells can have."""

import time

import pytest
import torch

from benchmark import harness
from mercury_tpu_torch.scale import serve


def _run(name="c9_pool4096_clean", fault=None, rx_options=None,
         seconds=0.5, **size):
    cell = harness.load_cell(name)
    cell.update(channels=3, ring_blocks=3, kept_every=1)
    cell.update(size)
    _run_, checks = harness.serve(cell, 2 ** 31 + 3, seconds, False,
                                  torch.device("cpu"), time.perf_counter(),
                                  {}, rx_options=rx_options, fault=fault)
    return checks


def stale_state(pool):
    """The round returns its previous result: its state left unchanged."""
    orig, last = pool.round, []

    def round_(block, next_block=None):
        last.append(orig(block, next_block=next_block))
        return last[-2] if len(last) > 1 else last[-1]
    pool.round = round_


def half_batch(pool):
    """Half of the channels' results left out."""
    orig = pool.unpack
    pool.unpack = lambda packed: [r for r in orig(packed)
                                  if r[0] < pool.n_channels // 2]


@pytest.mark.parametrize("name", ["c9_pool4096_clean", "c16_pool16384_threshold"])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_faults_fail(fault, name, monkeypatch):
    hooks = {"stale": stale_state, "half": half_batch}
    if fault == "altered":
        orig = serve._pack

        def pack(res, ok):
            out = orig(res, ok)
            out[:, 0] ^= 0x5A
            return out
        monkeypatch.setattr(serve, "_pack", pack)
    checks = _run(name, fault=hooks.get(fault))
    assert not harness.is_correct(checks), checks


def test_sound_small_run_is_correct():
    assert harness.is_correct(_run())


def test_clean_control_fails():
    cell = harness.load_cell("c9_pool4096_clean")
    checks = _run(rx_options=cell["control"]["rx_options"])
    assert checks["missed_share"]["value"] == 1.0
    assert not harness.is_correct(checks)


def test_threshold_control_fails():
    """CONFIG_16 at the cell's Es/N0 with its recovery switched off loses
    more frames than the limit allows (a ring of 8 blocks of 32 channels,
    every block in the window)."""
    cell = harness.load_cell("c16_pool16384_threshold")
    checks = _run("c16_pool16384_threshold", channels=32, ring_blocks=8,
                  seconds=4.0, rx_options=cell["control"]["rx_options"])
    assert not harness.is_correct(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c9_pool4096_clean", "c16_pool16384_threshold"])
def test_control_on_the_card(name):
    """The cell's own size on the card, three seeds: the program correct,
    its control not (run: python -m pytest -m cuda benchmark/tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import readings
    dev = torch.device("cuda", 0)
    seeds = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]
    for row in readings.readings(name, seeds, 4.0, False, dev):
        assert row["correct"], row
    for row in readings.readings(name, seeds, 4.0, True, dev):
        assert not row["correct"], row
