"""The port's observability module: `waterfall` (host numpy, copied)
gives the JAX package's spectrograms; `rx_diagnostics` on the port's chain
meets tests/test_obs_gbf.py:55-74's bars, and its constellation and channel
magnitude agree with the JAX chain's on the same buffer within 1e-3 of
their scale (the JAX chain mixes the found offset in float32 phase, ~1e-3
rad at these buffer lengths). The span recorder (the port's own, no JAX
counterpart) records nothing unless torch.profiler records or
`obs.recording()` is on, keeps nested spans with their n in a ring that
loses its oldest when it wraps, records in exactly a profiler schedule's
active steps, has no device time on the CPU, and in a CONFIG_16 pool round
near threshold marks the receive's stages, its host reads, its recovery
rows (as many as RxChain.recovery counts) and the unpack's result build,
without changing a byte of the results."""

import contextlib
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mercury_tpu import obs as jobs
from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch import obs
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import serve


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_waterfall_matches_jax():
    x = np.random.default_rng(0).standard_normal(5000)
    for a, b in zip(obs.waterfall(x), jobs.waterfall(x)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def ring():
    """An empty ring, emptied again after the test."""
    obs.clear()
    yield
    obs.clear()


def _names(s):
    return [str(x) for x in s["name"]]


def test_spans_off_record_nothing(ring):
    assert not torch.autograd.profiler._is_profiler_enabled
    with obs.span("a", 3):
        with obs.span("b", device=True):
            pass
    s = obs.spans()
    assert s["name"].size == s["start_ns"].size == s["n"].size == 0
    assert s["device_ms"] is None


def test_recording_nests_and_the_ring_wraps(ring):
    with obs.recording():
        with obs.span("outer", 7):
            with obs.span("inner", 2):
                time.sleep(0.002)
            with obs.span("inner", 3):
                pass
    s = obs.spans()
    # oldest first by opening: outer, then its two inner spans
    assert _names(s) == ["outer", "inner", "inner"]
    assert s["n"].tolist() == [7, 2, 3]
    assert np.all(s["end_ns"] >= s["start_ns"])
    assert s["start_ns"][0] <= s["start_ns"][1] <= s["end_ns"][1] \
        <= s["start_ns"][2] <= s["end_ns"][2] <= s["end_ns"][0]
    assert s["end_ns"][1] - s["start_ns"][1] >= 2_000_000
    obs.clear()
    with obs.recording():
        for i in range(obs.CAPACITY + 2):
            with obs.span("first" if i < 2 else "later", i):
                pass
    s = obs.spans()
    assert s["n"].size == obs.CAPACITY and set(_names(s)) == {"later"}
    assert s["n"].tolist() == list(range(2, obs.CAPACITY + 2))


def test_threads_record_their_own_spans(ring):
    """Eight threads nest spans at once with the interpreter switching
    threads often: every span is closed in its own row, none lost."""
    per, n_threads = 300, 8

    def work(t):
        for i in range(per):
            with obs.span("outer", t):
                with obs.span("inner", i):
                    time.sleep(0)           # hand the interpreter over

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.recording():
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
    s = obs.spans()
    outer, inner = s["name"] == "outer", s["name"] == "inner"
    assert outer.sum() == inner.sum() == per * n_threads
    assert s["n"][outer].sum() == per * sum(range(n_threads))
    assert s["n"][inner].sum() == n_threads * sum(range(per))
    assert np.all(s["end_ns"] >= s["start_ns"])


def test_spans_in_the_profilers_active_steps_only(ring):
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=3,
                                   repeat=1)) as prof:
        for step in range(6):
            with obs.span("step", step):
                torch.ones(4).sum()
            prof.step()
    with obs.span("after"):
        pass
    s = obs.spans()
    assert _names(s) == ["step"] * 3 and s["n"].tolist() == [1, 2, 3]
    # each recorded span is a record_function range on the trace
    assert sum(e.name == "step" for e in prof.events()) == 3


def test_device_ms_is_none_on_the_cpu(ring):
    with obs.recording():
        with obs.span("d", device=torch.device("cpu")):
            pass
        with obs.span("e", device=False):
            pass
    s = obs.spans()
    assert _names(s) == ["d", "e"] and s["device_ms"] is None


def test_config16_pool_round_spans(ring):
    """A CONFIG_16 round of 8 channels at 20.5 dB: some rows fail their
    first decode and BICM-ID recovers them; the spans cover the receive,
    its reads and recovery passes and the unpack's build, and the results
    are those of a round with the recorder off."""
    g = port_geometry(16)
    rx = RxChain(g, device="cpu")
    rng = np.random.default_rng(5)
    n_ch = 8
    payloads = rng.integers(0, 256, (n_ch, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g, device="cpu").transmit(
        torch.from_numpy(payloads)).numpy()
    results = []
    for on in (False, True):
        pool = serve.FusedDevicePool(g, n_ch, rx=rx)
        if not results:
            block = (sim.sigma_for_esn0(20.5) * rng.standard_normal(
                (n_ch, pool.buf_len))).astype(np.float32)
            for c in range(n_ch):
                lead = (1 + c % 3) * pool.sym_len + 37 * c
                block[c, lead: lead + frames.shape[1]] += frames[c]
        before = sum(rx.recovery.values())
        with obs.recording() if on else contextlib.nullcontext():
            packed = pool.round(block)
            out = pool.unpack(packed)
        results.append((packed.numpy().copy(), out))
        if not on:
            assert obs.spans()["name"].size == 0
    grew = sum(rx.recovery.values()) - before
    s = obs.spans()
    names = _names(s)
    assert set(names) == {"rx.acquire", "rx.decode", "rx.recovery",
                          "rx.read", "pool.unpack.build"}
    assert names[:2] == ["rx.acquire", "rx.decode"]
    assert names[-1] == "pool.unpack.build"
    rec = s["name"] == "rx.recovery"
    assert grew > 0 and int(s["n"][rec].sum()) == grew
    # a recovery pass follows the read of its rows, inside the decode
    assert all(names[i - 1] == "rx.read" for i in np.flatnonzero(rec))
    dec = names.index("rx.decode")
    assert np.all(s["start_ns"][rec] >= s["start_ns"][dec])
    assert np.all(s["end_ns"][rec] <= s["end_ns"][dec])
    (off, out_off), (on_, out_on) = results
    np.testing.assert_array_equal(off, on_)
    assert [c for c, _ in out_off] == [c for c, _ in out_on] \
        == list(range(n_ch))
    for (_c, a), (_d, b) in zip(out_off, out_on):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name))
    assert {bytes(r.payload[0]) for _c, r in out_on} == {
        bytes(p) for p in payloads}


def test_rx_diagnostics_matches_jax():
    """CONFIG_9 at 14 dB, a frame at sample 7000 shifted by 12 Hz: the bars
    of tests/test_obs_gbf.py:55-74, then the same fields as the JAX
    diagnostics."""
    g = build_geometry(9)
    payload = np.arange(g.frame_bytes, dtype=np.uint8)[None]
    frame = sim.apply_cfo(TxChain(port_geometry(9), device="cpu").transmit(
        torch.as_tensor(payload)), g.fs, g.fc, 12.0).numpy()[0]
    n = g.nofdm * g.buffer_nsymb * g.interp
    rng = np.random.default_rng(1)
    buf = rng.standard_normal(n) * sim.sigma_for_esn0(14.0)
    buf[7000: 7000 + len(frame)] += frame
    buf = buf.astype(np.float32)
    d = obs.rx_diagnostics(RxChain(port_geometry(9), device="cpu"), buf)
    assert d["crc_ok"]
    assert d["constellation"].shape == (g.n_data,)
    assert d["channel_mag"].shape == (g.nsymb, g.nc)
    assert d["sync_metric"].max() > 0.7
    assert d["waterfall"].shape[1] == 257
    assert all(isinstance(v, np.ndarray) for k, v in d.items()
               if k in ("sync_metric", "constellation", "channel_mag",
                        "waterfall", "waterfall_freqs"))
    want = jobs.rx_diagnostics(JaxRx(g), buf)
    assert d["delay"] == want["delay"] and d["crc_ok"] == want["crc_ok"]
    assert abs(d["freq_offset"] - want["freq_offset"]) < 0.05
    assert abs(d["snr_db"] - want["snr_db"]) < 0.05
    np.testing.assert_allclose(d["sync_metric"], want["sync_metric"],
                               atol=1e-4)
    for key in ("constellation", "channel_mag"):
        np.testing.assert_allclose(d[key], want[key],
                                   atol=1e-3 * np.abs(want[key]).max())
    assert abs(d["pilot_variance"] - want["pilot_variance"]) < 1e-3
    np.testing.assert_array_equal(d["waterfall"], want["waterfall"])
