"""mercury_tpu_torch.modem.sync against mercury_tpu.modem.sync on one
noisy CONFIG_3 time-sync baseband: argmax positions and delays exact,
values to rtol 1e-4 (float32 prefix sums and FFTs in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem import sync as jsync
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.dsp import ops
from mercury_tpu_torch.modem import sync
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain


@pytest.fixture(scope="module")
def case():
    g = build_geometry(3)
    tg = port_geometry(3)
    rng = np.random.default_rng(33)
    payload = rng.integers(0, 256, (2, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(tg, device="cpu").transmit(
        torch.as_tensor(payload)).numpy()
    n = g.nofdm * g.buffer_nsymb * g.interp
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = rng.standard_normal((2, n)) * sim.sigma_for_esn0(3.0)
    buf[:, delay: delay + frames.shape[1]] += frames
    rx = RxChain(tg, device="cpu")
    pb = torch.as_tensor(buf.astype(np.float32))
    bb_ts = ops.fir_same_strided(rx.mix(pb), rx._fir_ts, g.interp)
    return g, rx, bb_ts, delay


def test_schmidl_cox_metric(case):
    g, _rx, bb_ts, delay = case
    met, cfo = sync.schmidl_cox_metric(bb_ts, _rx.geom, decim=g.interp,
                                       scan=4)
    met_j, cfo_j = jsync.schmidl_cox_metric(jnp.asarray(bb_ts.numpy()), g,
                                            decim=g.interp, use_mm=False,
                                            scan=4)
    np.testing.assert_array_equal(met.argmax(-1).numpy(),
                                  np.asarray(met_j).argmax(-1))
    np.testing.assert_allclose(met.numpy(), np.asarray(met_j), rtol=1e-4,
                               atol=1e-5)
    # the CFO is an angle: compare where the metric is significant
    sig = np.asarray(met_j) > 0.1
    np.testing.assert_allclose(cfo.numpy()[sig], np.asarray(cfo_j)[sig],
                               rtol=1e-4, atol=1e-3)
    # the peak is the frame's preamble
    peak = met.argmax(-1).numpy() * 4 * g.interp
    assert (np.abs(peak - delay) <= g.ngi * g.interp * 2).all()


def test_matched_filter_refine_bank(case):
    g, rx, bb_ts, delay = case
    tmpl = rx._mf_templates[:, ::8]
    bank = rx._rotated_bank(tmpl, (0.0, 93.75, -93.75), 8)
    window = 272
    seg = bb_ts[:, delay // 4 - 2 * window: delay // 4 - 2 * window
                + (2 * window + tmpl.numel()) * 2: 2]
    start = torch.tensor([11, 3])
    d, s = sync.matched_filter_refine_bank(seg, start, bank, window)
    d_j, s_j = jsync.matched_filter_refine_bank(
        jnp.asarray(seg.numpy()), jnp.asarray(start.numpy()), bank.numpy(),
        window)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-4)
    assert (d[:, 0] - start == window).all()


def test_moose_cfo(case):
    g, rx, _bb_ts, delay = case
    pb = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (3, g.nofdm * g.buffer_nsymb * g.interp)).astype(np.float32))
    frame = rx.extract_frame_decimated_pb(pb, torch.tensor([0, 500, 9000]),
                                          g.nsymb)
    t = torch.arange(frame.shape[-1], dtype=torch.float32) * g.interp
    frame = frame * torch.polar(torch.ones_like(t), 2 * np.pi * 7.0 / g.fs * t)
    f = sync.moose_cfo(frame, rx.geom, rx._pad_map)
    f_j = jsync.moose_cfo(jnp.asarray(frame.numpy()), g)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=1e-4,
                               atol=1e-4)
