"""The host runtime and the streaming receiver of the port against the JAX
package's: `mercury_tpu_torch/runtime/runtime.cc` is a byte copy of
`mercury_tpu/native/runtime.cc`, and its bindings give the same snapshots,
`ready` and `n_under` on a scripted push/arm sequence; `StreamReceiver` on a
short two-frame CONFIG_9 stream decodes the same frames, in the same order,
at the same delays as the JAX one (batch-1 receives, on the CPU here)."""

import pathlib

import numpy as np
import pytest
import torch

from mercury_tpu import native as jnative
from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem.stream import StreamReceiver as JaxStream
from mercury_tpu_torch import runtime
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.stream import StreamReceiver
from mercury_tpu_torch.modem.tx import TxChain

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_runtime_source_is_a_byte_copy():
    assert ((ROOT / "mercury_tpu_torch/runtime/runtime.cc").read_bytes()
            == (ROOT / "mercury_tpu/native/runtime.cc").read_bytes())
    assert runtime.ensure_built().parent == ROOT / "build" / "mercury_tpu_torch"


def test_sliding_window_and_ring_match_jax():
    """The same scripted pushes (whole symbols, a partial one, more than a
    window), arms and clears on both packages' windows and rings: equal
    snapshots, ready, n_under, reads and sizes after every step."""
    rng = np.random.default_rng(0)
    sym, win_len = 8, 40
    ours = runtime.SlidingWindow(win_len, sym)
    theirs = jnative.SlidingWindow(win_len, sym)
    script = [("arm", 3), ("push", 8), ("push", 8), ("push", 5),
              ("push", 11), ("push", 64), ("arm", 1), ("push", 8),
              ("arm", 2), ("push", 16), ("clear", None), ("arm", 4),
              ("push", 24), ("push", 8)]
    for op, arg in script:
        if op == "push":
            x = rng.standard_normal(arg).astype(np.float32)
            ours.push(x)
            theirs.push(x)
        elif op == "arm":
            ours.arm(arg)
            theirs.arm(arg)
        else:
            ours.clear()
            theirs.clear()
        assert ours.ready == theirs.ready, (op, arg)
        assert ours.n_under == theirs.n_under, (op, arg)
        (a, ra), (b, rb) = ours.snapshot(), theirs.snapshot()
        assert ra == rb
        np.testing.assert_array_equal(a, b)
    ring, jring = runtime.SampleRing(100), jnative.SampleRing(100)
    for n_write, n_read in ((30, 10), (90, 50), (5, 200)):
        x = rng.standard_normal(n_write).astype(np.float32)
        assert ring.write(x) == jring.write(x)
        assert len(ring) == len(jring)
        np.testing.assert_array_equal(ring.read(n_read), jring.read(n_read))
    ring.clear()
    assert len(ring) == 0
    pool, jpool = runtime.WindowPool(3, 16, 4), jnative.WindowPool(3, 16, 4)
    block = rng.standard_normal((3, 12)).astype(np.float32)
    for p in (pool, jpool):
        p.arm_many(np.array([0, 2]), np.array([2, 5]))
        p.feed_block(block)
    assert pool.ready_count == jpool.ready_count
    for a, b in zip(pool.gather_ready(), jpool.gather_ready()):
        np.testing.assert_array_equal(a, b)


def test_stream_receiver_matches_jax():
    """Two CONFIG_9 frames with gaps, fed in 100 ms chunks: the first full
    window holds both (iterative cancellation decodes each), then the
    stream ends. Frames, order and delays equal to the JAX receiver's."""
    g = build_geometry(9)
    payloads = np.stack([np.full(g.frame_bytes, 10 * i, np.uint8)
                         for i in (1, 2)])
    frames = TxChain(port_geometry(9), device="cpu").transmit(
        torch.as_tensor(payloads)).numpy()
    rng = np.random.default_rng(0)
    stream = np.concatenate([np.zeros(3000, np.float32), frames[0],
                             np.zeros(4000, np.float32), frames[1],
                             np.zeros(30000, np.float32)])
    stream = stream + 0.002 * rng.standard_normal(len(stream)).astype(
        np.float32)
    ours = StreamReceiver(port_geometry(9),
                          rx=RxChain(port_geometry(9), device="cpu"))
    theirs = JaxStream(g)
    got, want = [], []
    for pos in range(0, len(stream), 4800):
        got += ours.feed(stream[pos: pos + 4800])
        want += theirs.feed(stream[pos: pos + 4800])
    assert len(got) == len(want) == 2
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(a.crc_ok[0]) and bool(np.asarray(b.crc_ok)[0])
        np.testing.assert_array_equal(a.payload[0].numpy(), payloads[i])
        np.testing.assert_array_equal(a.payload[0].numpy(),
                                      np.asarray(b.payload)[0])
        assert int(a.delay[0]) == int(np.asarray(b.delay)[0])
    assert ours._frames_decoded == theirs._frames_decoded == 2
