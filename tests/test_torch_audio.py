"""The port's audio I/O (`mercury_tpu_torch.runtime.audio`, over the port's
runtime SampleRing and SlidingWindow) on tests/test_audio.py's scenarios:
the loopback cable, the three-thread window, gains, the tune tone, the
burst transport and the libasound contract stub (open/params, channel
routing, xrun recovery, device listing), plus the terminal dashboard
against the JAX package's on the same samples."""

import ctypes.util
import os
import pathlib
import subprocess
import time

import numpy as np
import pytest

from mercury_tpu import dashboard as jdashboard
from mercury_tpu_torch import dashboard
from mercury_tpu_torch.runtime import audio
from mercury_tpu_torch.runtime.audio import (LEFT, RIGHT, AlsaDevice,
                                             AudioBurstTransport, AudioIO,
                                             LoopbackDevice)
from mercury_tpu_torch.runtime.runtime import SlidingWindow


def test_audio_runs_on_the_ports_runtime():
    assert audio.SlidingWindow is SlidingWindow


def test_loopback_device_cable():
    a, b = LoopbackDevice.pair()
    a.write(np.arange(10, dtype=np.float32))
    np.testing.assert_array_equal(b.read(10), np.arange(10, dtype=np.float32))
    a.write(np.arange(7, dtype=np.float32))
    assert len(b.read(3)) == 3
    np.testing.assert_array_equal(b.read(4), np.arange(3, 7, dtype=np.float32))


def test_audioio_end_to_end_window():
    """playback thread -> cable -> capture thread -> capture-prep window:
    the last 4 symbols of the ready window are the TX samples."""
    a_dev, b_dev = LoopbackDevice.pair()
    symbol_len, nsymb = 1088, 8
    tx = np.random.default_rng(0).standard_normal(
        symbol_len * 4).astype(np.float32)
    io = AudioIO(playback_dev=a_dev, capture_dev=b_dev,
                 symbol_len=symbol_len, window_nsymb=nsymb, block=512)
    io.start()
    try:
        io.arm(4)
        io.tx_transfer(tx)
        deadline = time.monotonic() + 5.0
        ready = False
        while time.monotonic() < deadline and not ready:
            win, ready = io.rx_window()
            time.sleep(0.02)
        assert ready, "capture-prep window never became ready"
        np.testing.assert_allclose(win[-len(tx):], tx, atol=1e-6)
    finally:
        io.stop()


def test_audioio_gains():
    a_dev, b_dev = LoopbackDevice.pair()
    io = AudioIO(playback_dev=a_dev, capture_dev=b_dev, symbol_len=256,
                 window_nsymb=4, tx_gain_db=6.0, block=256)
    try:
        io.tx_transfer(np.ones(10, np.float32))
        chunk = io.playback_buffer.read(10, timeout_ms=100)
        np.testing.assert_allclose(chunk, 10 ** (6 / 20.0), rtol=1e-6)
    finally:
        io.playback_dev.close()


def test_tune_tone_through_thread():
    """With tune on, the live playback thread emits the 1500 Hz tone at
    0.9 amplitude."""
    a_dev, b_dev = LoopbackDevice.pair()
    io = AudioIO(playback_dev=a_dev, capture_dev=b_dev, symbol_len=256,
                 window_nsymb=4, block=480, use_window=False)
    io.set_tune(True)
    io.start()
    try:
        deadline = time.monotonic() + 3.0
        got = np.zeros(0, np.float32)
        while time.monotonic() < deadline and len(got) < 2000:
            got = np.concatenate([got, b_dev.read(480)])
            time.sleep(0.01)
        assert len(got) >= 2000
        seg = got[:1920]
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        assert abs(np.argmax(spec) * 48000.0 / len(seg) - 1500.0) < 50.0
        assert 0.85 <= np.max(np.abs(seg)) <= 0.91
    finally:
        io.stop()
    io.set_tune(False)
    assert not io.tune_active


def test_burst_transport_segments_on_silence():
    a_dev, b_dev = LoopbackDevice.pair()
    io = AudioIO(playback_dev=a_dev, capture_dev=b_dev, symbol_len=256,
                 window_nsymb=4, block=512, use_window=False)
    io.start()
    try:
        t = AudioBurstTransport(io, squelch=1e-3, hang_samples=2048)
        burst = (0.5 * np.random.default_rng(1).standard_normal(6000)
                 ).astype(np.float32)
        t.transmit(np.concatenate([burst, np.zeros(8000, np.float32)]))
        deadline = time.monotonic() + 5.0
        got = None
        while time.monotonic() < deadline and got is None:
            got = t.capture()
            time.sleep(0.02)
        assert got is not None, "burst never emitted"
        assert len(got) >= 6000
        np.testing.assert_allclose(got[:6000], burst, atol=1e-6)
    finally:
        io.stop()


@pytest.fixture(scope="module")
def alsa_stub(tmp_path_factory):
    """tests/alsa_stub's libasound contract stub, built with gcc, in place
    of libasound for AlsaDevice."""
    src = pathlib.Path(__file__).parent / "alsa_stub" / "alsa_stub.c"
    so = tmp_path_factory.mktemp("alsa") / "libasound_stub.so"
    subprocess.run(["gcc", "-O1", "-shared", "-fPIC", str(src), "-o",
                    str(so)], check=True)
    log = so.parent / "transcript.log"
    orig = ctypes.util.find_library

    def fake_find(name):
        return str(so) if name == "asound" else orig(name)

    ctypes.util.find_library = fake_find
    os.environ["ALSA_STUB_LOG"] = str(log)
    yield {"log": log, "ctrl": ctypes.CDLL(str(so))}
    ctypes.util.find_library = orig
    os.environ.pop("ALSA_STUB_LOG", None)


def test_alsa_contract_params_and_loopback(alsa_stub):
    alsa_stub["ctrl"].alsa_stub_reset()
    alsa_stub["log"].write_text("")
    play = AlsaDevice("stub0", capture=False, rate=48000, channels=2)
    cap = AlsaDevice("stub0", capture=True, rate=48000, channels=2)
    tx = np.linspace(-0.5, 0.5, 480).astype(np.float32)
    assert play.write(tx) == 480
    np.testing.assert_allclose(cap.read(480), tx, atol=1e-7)
    play.close()
    cap.close()
    t = alsa_stub["log"].read_text()
    assert "open name=stub0 stream=0" in t
    assert "open name=stub0 stream=1" in t
    assert "set_params format=14 access=3 channels=2 rate=48000" in t
    assert t.count("close") == 2


def test_alsa_contract_channel_routing(alsa_stub):
    alsa_stub["ctrl"].alsa_stub_reset()
    play = AlsaDevice("stub0", capture=False, channels=2, channel=LEFT)
    cap_r = AlsaDevice("stub0", capture=True, channels=2, channel=RIGHT)
    cap_l = AlsaDevice("stub0", capture=True, channels=2, channel=LEFT)
    tx = np.ones(100, np.float32)
    play.write(tx)
    np.testing.assert_array_equal(cap_r.read(100), np.zeros(100, np.float32))
    play.write(tx)
    np.testing.assert_array_equal(cap_l.read(100), tx)
    for d in (play, cap_r, cap_l):
        d.close()


def test_alsa_contract_xrun_recovery(alsa_stub):
    alsa_stub["ctrl"].alsa_stub_reset()
    play = AlsaDevice("stub0", capture=False, channels=1)
    cap = AlsaDevice("stub0", capture=True, channels=1)
    alsa_stub["ctrl"].alsa_stub_arm_xrun()
    tx = np.arange(64, dtype=np.float32)
    assert play.write(tx) == 64
    assert alsa_stub["ctrl"].alsa_stub_recover_calls() == 1
    np.testing.assert_array_equal(cap.read(64), tx)
    play.close()
    cap.close()


def test_alsa_contract_device_listing(alsa_stub):
    assert "stubpcm0" in AlsaDevice.list_devices()


def test_dashboard_frame_matches_jax():
    """The same samples and state through both packages' dashboards (the
    port's over its own obs.waterfall) give the same screen."""
    samples = (0.1 * np.random.default_rng(5).standard_normal(48000)
               ).astype(np.float32)
    state = {"config": 9, "link_status": "CONNECTED", "snr_db": 12.5,
             "cfo_hz": 1.25, "signal_dbm": -40.0, "noise_floor_dbm": -60.0,
             "rx_level_dbfs": dashboard.level_dbfs(samples)}
    const = np.exp(1j * np.pi / 4 * np.arange(8))
    frames = []
    for mod in (dashboard, jdashboard):
        d = mod.Dashboard(color=False)
        d.update_samples(samples)
        frames.append(d.frame(state, const))
    assert frames[0] == frames[1]
    assert "waterfall" in frames[0] and "constellation" in frames[0]
