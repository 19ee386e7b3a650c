"""mercury_tpu_torch.channel.sim: the frame lands at its delay and the
noise has the calibrated statistics (its samples come from a
torch.Generator, so only statistics are comparable with the JAX package)."""

import numpy as np
import pytest
import torch

from mercury_tpu.channel import sim as jsim
from mercury_tpu_torch.channel import sim


def test_sigma_matches_reference_convention():
    for esn0 in (-5.0, 0.0, 12.0):
        assert sim.sigma_for_esn0(esn0) == pytest.approx(
            jsim.sigma_for_esn0(esn0), rel=1e-15)


def test_awgn_passband_placement_and_statistics():
    frame = torch.randn(4, 3000, generator=torch.Generator().manual_seed(1))
    sigma = sim.sigma_for_esn0(6.0)
    buf = sim.awgn_passband(frame, sigma, 1000, 200_000,
                            torch.Generator().manual_seed(2))
    assert buf.shape == (4, 200_000) and buf.dtype == torch.float32
    quiet = sim.awgn_passband(frame, 0.0, 1000, 200_000,
                              torch.Generator().manual_seed(2))
    torch.testing.assert_close(quiet[:, 1000:4000], frame, rtol=0, atol=0)
    assert (quiet[:, :1000] == 0).all() and (quiet[:, 4000:] == 0).all()
    noise = torch.cat([buf[:, :1000], buf[:, 4000:]], dim=-1).double()
    # 4 x 197000 samples: the std of the estimate is ~0.08% of sigma
    assert abs(noise.std().item() / sigma - 1.0) < 0.005
    assert abs(noise.mean().item()) < 0.005 * sigma
    torch.testing.assert_close(buf[:, 1000:4000] - frame,
                               buf[:, 1000:4000] - quiet[:, 1000:4000])
    # the same generator seed gives the same buffer
    again = sim.awgn_passband(frame, sigma, 1000, 200_000,
                              torch.Generator().manual_seed(2))
    torch.testing.assert_close(again, buf, rtol=0, atol=0)

