"""The port's ARQ link (`mercury_tpu_torch.link`) against the JAX package's,
on the CPU: the host modules are copies of the originals; a whole two-node
session on the same seed gives the same bytes, event log, final configs,
statistics and simulated time in both packages; a JAX node and a port node
complete transfers in both directions on one simulator (the wire format is
the contract, not the class); and the JAX link scenarios (selective ACK,
BREAK recovery, transport jitter, idle measurement, the stock wire-compat
session and the stock BREAK tone) hold on the port."""

import pathlib

import numpy as np
import pytest
import torch

from mercury_tpu.link import node as jnode
from mercury_tpu.link import protocol as JP
from mercury_tpu.link import sim as jsim
from mercury_tpu_torch.core.modes import ROBUST_0
from mercury_tpu_torch.link import node, protocol as P, sim

REPO = pathlib.Path(__file__).resolve().parent.parent
CID = 0x2A

# port file -> (its original, the port's lines that differ, the original's
# lines they replace): outside those lines the two files are equal
COPIES = {
    "link/protocol.py": ("link/protocol.py", [], []),
    "link/transport.py": ("link/transport.py", [], []),
    "link/tcp_api.py": ("link/tcp_api.py", [
        "from mercury_tpu_torch.link import protocol as P",
        "from mercury_tpu_torch.link.node import ArqConfig, ArqNode",
        "                 config: ArqConfig | None = None, transport=None,",
        "                 device=None):",
        "                            on_event=self._on_node_event, "
        "device=device)",
    ], [
        "from mercury_tpu.link import protocol as P",
        "from mercury_tpu.link.node import ArqConfig, ArqNode",
        "                 config: ArqConfig | None = None, transport=None):",
        "                            on_event=self._on_node_event)",
    ]),
    "core/settings.py": ("core/settings.py", [
        "        from mercury_tpu_torch.link.node import ArqConfig",
    ], [
        "        from mercury_tpu.link.node import ArqConfig",
    ]),
    "runtime/audio.py": ("native/audio.py", [
        "from mercury_tpu_torch.runtime.runtime import SampleRing, "
        "SlidingWindow",
    ], [
        "from mercury_tpu.native.runtime import SampleRing, SlidingWindow",
    ]),
    "dashboard.py": ("dashboard.py", [
        "        from mercury_tpu_torch.obs import waterfall",
    ], [
        "        from mercury_tpu.obs import waterfall",
    ]),
    "gui.py": ("gui.py", [
        "        from mercury_tpu_torch.dashboard import level_dbfs",
        "        from mercury_tpu_torch.obs import waterfall",
    ], [
        "        from mercury_tpu.dashboard import level_dbfs",
        "        from mercury_tpu.obs import waterfall",
    ]),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _without(lines: list[str], masked: list[str]) -> list[str]:
    for m in masked:
        assert lines.count(m) == 1, f"masked line not found once: {m!r}"
    return [ln for ln in lines if ln not in masked]


@pytest.mark.parametrize("port_rel", sorted(COPIES))
def test_host_module_is_a_copy(port_rel):
    jax_rel, port_masked, jax_masked = COPIES[port_rel]
    ours = (REPO / "mercury_tpu_torch" / port_rel).read_text().splitlines()
    theirs = (REPO / "mercury_tpu" / jax_rel).read_text().splitlines()
    assert _without(ours, port_masked) == _without(theirs, jax_masked)


@pytest.mark.parametrize("kw", [
    dict(snr_db=10.0), dict(cfo_hz=12.5, snr_db=15.0),
    dict(fading="moderate", snr_db=20.0, fading_horizon_s=30.0)],
    ids=["awgn", "cfo", "fading"])
def test_channel_model_matches_jax(kw):
    """The same block through both packages' channel models, twice (the
    noise stream and the fading time advance): AWGN and fading are the same
    numpy arithmetic, exact; the carrier offset is an FFT shift in float64
    in both (torch on a CPU tensor; JAX under the suite's x64), held to
    1e-9 of the signal's peak."""
    block = np.random.default_rng(7).standard_normal(9000).astype(np.float32)
    ours, theirs = sim.ChannelModel(seed=3, **kw), jsim.ChannelModel(seed=3,
                                                                     **kw)
    for now_s in (0.0, 1.5):
        ours.now_s = theirs.now_s = now_s
        got, want = ours.apply(block), theirs.apply(block)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(block).max())


# ---------------------------------------------------------------------------
# whole sessions: the port against JAX, and mixed pairs
# ---------------------------------------------------------------------------

PKGS = {"jax": (jnode, JP, jsim, {}), "port": (node, P, sim,
                                              {"device": "cpu"})}


def _node(pkg, call, role, **cfg):
    nd, proto, _sim, kw = PKGS[pkg]
    events = []
    n = nd.ArqNode(call, proto.COMMANDER if role == "cmd" else
                   proto.RESPONDER, nd.ArqConfig(**cfg),
                   on_event=events.append, **kw)
    return n, events


def _session(cmd_pkg, rsp_pkg, init_cfg=0, snr_db=20.0, payload_len=120,
             gear=True, batch=3, seed=0):
    """tests/test_link.py's _session with each end from a chosen package;
    the simulator and channel are the commander's package's."""
    cfg = dict(init_configuration=init_cfg, gear_shift_on=gear,
               robust_enabled=False, batch_size=batch)
    cmd, cmd_ev = _node(cmd_pkg, "VE3XYZ", "cmd", **cfg)
    rsp, rsp_ev = _node(rsp_pkg, "N0CALL", "rsp", **cfg)
    s = PKGS[cmd_pkg][2]
    link = s.LinkSimulator(cmd, rsp, s.ChannelModel(snr_db=snr_db, seed=seed))
    payload = bytes(np.random.default_rng(seed).integers(0, 256, payload_len)
                    .astype(np.uint8))
    cmd.send_data(payload)
    cmd.connect("N0CALL")
    t = link.run(max_sim_s=1800,
                 until=lambda: len(rsp.fifo_rx) >= payload_len)
    return cmd, rsp, payload, rsp.received(), cmd_ev, rsp_ev, t


def test_session_matches_jax():
    """CONFIG_0, gearshift on, 20 dB, the same seed and payload: the same
    bytes, event logs, final configs, link statistics and simulated time
    (the session climbs one gear: SET_CONFIG, the sibling-frame decode and
    the pattern ACKs all run)."""
    want = _session("jax", "jax")
    got = _session("port", "port")
    assert got[3] == got[2] == want[3]
    assert got[4] == want[4] and got[5] == want[5]
    assert any(e.startswith("GEARSHIFT") for e in got[4])
    assert got[0].current_configuration == want[0].current_configuration
    assert got[1].current_configuration == want[1].current_configuration
    assert vars(got[0].stats) == vars(want[0].stats)
    assert vars(got[1].stats) == vars(want[1].stats)
    assert got[6] == want[6]


@pytest.mark.parametrize("cmd_pkg,rsp_pkg", [("jax", "port"),
                                             ("port", "jax")])
def test_mixed_session_completes(cmd_pkg, rsp_pkg):
    cmd, rsp, sent, got, _ce, _re, _t = _session(cmd_pkg, rsp_pkg)
    assert got == sent
    assert cmd.link_status == P.CONNECTED
    assert cmd.current_configuration == rsp.current_configuration


@pytest.mark.parametrize("a_pkg,b_pkg", [("jax", "port"), ("port", "jax")])
def test_mixed_switch_role(a_pkg, b_pkg):
    """tests/test_link.py::test_switch_role_bidirectional with one end from
    each package, at CONFIG_0 (the JAX test's runs at CONFIG_6): the JAX
    chains that test_session_matches_jax compiled serve it."""
    cfg = dict(init_configuration=0, gear_shift_on=False, batch_size=3)
    a, _ = _node(a_pkg, "VE3XYZ", "cmd", **cfg)
    b, _ = _node(b_pkg, "N0CALL", "rsp", **cfg)
    s = PKGS[a_pkg][2]
    link = s.LinkSimulator(a, b, s.ChannelModel(snr_db=20))
    fwd = bytes(np.random.default_rng(1).integers(0, 256, 150)
                .astype(np.uint8))
    rev = bytes(np.random.default_rng(2).integers(0, 256, 120)
                .astype(np.uint8))
    a.send_data(fwd)
    b.send_data(rev)
    a.connect("N0CALL")
    link.run(max_sim_s=600, until=lambda: len(b.fifo_rx) >= len(fwd))
    assert b.received() == fwd
    a.switch_role()
    link.run(max_sim_s=600, until=lambda: len(a.fifo_rx) >= len(rev))
    assert a.received() == rev
    assert a.role == P.RESPONDER and b.role == P.COMMANDER


# ---------------------------------------------------------------------------
# the JAX link scenarios, restated on the port
# ---------------------------------------------------------------------------

def _pair(**cfg):
    c = node.ArqConfig(**cfg)
    return (node.ArqNode("VE3XYZ", P.COMMANDER, c, device="cpu"),
            node.ArqNode("N0CALL", P.RESPONDER, c, device="cpu"))


def test_selective_ack_resends_only_missing_frame():
    """tests/test_link.py:185: one corrupted frame of a 5-frame block is
    recovered by a selective ACK that makes the commander resend exactly
    that frame."""
    a, b = _pair(init_configuration=6, gear_shift_on=False, batch_size=5)
    frame_len = a.geom.total_frame_size

    def kill_frame_2(idx, samples):
        if idx == 2:
            samples = samples.copy()
            samples[2 * frame_len: 3 * frame_len] = 0.0
        return samples

    link = sim.LinkSimulator(a, b, sim.ChannelModel(snr_db=20,
                                                    mutilate=kill_frame_2))
    payload = bytes(np.random.default_rng(9).integers(
        0, 256, 5 * a.max_data_length).astype(np.uint8))
    a.send_data(payload)
    a.connect("N0CALL")
    link.run(max_sim_s=900, until=lambda: len(b.fifo_rx) >= len(payload))
    assert b.received() == payload
    assert a.stats.resent_data == 1
    assert b.stats.selective_acks_sent >= 1
    assert a.stats.selective_acks_received >= 1
    assert a.stats.blocks_acked >= 1


def test_break_recovery_on_bad_channel():
    """tests/test_link.py:56: starting at CONFIG_13 on a 7 dB channel, the
    emergency BREAK fires, both ends meet at the ladder floor and the
    transfer completes."""
    cmd, rsp, sent, got, cmd_ev, rsp_ev, _t = _session(
        "port", "port", init_cfg=13, snr_db=7, payload_len=300, seed=2)
    assert got == sent
    assert cmd.stats.breaks_sent >= 1
    assert any("BREAK" in e for e in cmd_ev + rsp_ev)


def test_receive_frames_tolerates_transport_jitter():
    """tests/test_link.py:398: sibling frames shifted by up to +-180
    samples from their slots still decode: refine_decode at batch 3."""
    from mercury_tpu_torch.modem.tx import TxChain
    rsp = node.ArqNode("N0CALL", P.RESPONDER,
                       node.ArqConfig(init_configuration=1), device="cpu")
    rsp.link_status = P.CONNECTED
    g = rsp.geom
    tx = TxChain(g, device="cpu")
    rng = np.random.default_rng(3)
    msgs, frames = [], []
    for i in range(3):
        chunk = bytes(rng.integers(0, 256, 10).astype(np.uint8))
        m = P.Message(type=P.DATA_SHORT, id=i, sequence=7, length=len(chunk),
                      data=chunk)
        msgs.append(m)
        payload = P.serialize(m, rsp.connection_id)
        buf = np.zeros(g.frame_bytes, np.uint8)
        buf[: len(payload)] = np.frombuffer(payload, np.uint8)
        frames.append(tx.transmit_batch(torch.from_numpy(buf[None]))
                      .numpy().reshape(-1))
    frame_len = g.total_frame_size
    jitter = [0, +180, -170]
    stream = np.zeros(3 * frame_len + 400, np.float32)
    for k, f in enumerate(frames):
        at = k * frame_len + (jitter[k] if k else 0)
        stream[at: at + len(f)] += f.astype(np.float32)
    assert rsp._receive_frames(stream[: 3 * frame_len], 0.0)
    assert sorted(rsp._rx_msgs) == [0, 1, 2]
    for i, m in enumerate(msgs):
        got = rsp._rx_msgs[i]
        assert got.data[: got.length] == m.data


def test_idle_channel_signal_measurement():
    """tests/test_link.py:362: noise windows feed the noise-floor EMA, twice
    the noise reads ~6 dB up, a frame reads far above the floor, and the
    idle estimate seeds TEST_CONNECTION."""
    import struct

    from mercury_tpu_torch.modem.tx import TxChain
    rsp = node.ArqNode("N0CALL", P.RESPONDER,
                       node.ArqConfig(init_configuration=0), device="cpu")
    g = rsp.geom
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    rng = np.random.default_rng(0)
    sigma = 0.003
    for i in range(4):
        rsp.on_samples(sigma * rng.standard_normal(buf_len)
                       .astype(np.float32), float(i))
    assert rsp.signal_dbm is not None and rsp.noise_floor_dbm is not None
    floor = rsp.noise_floor_dbm
    rsp.on_samples(2 * sigma * rng.standard_normal(buf_len)
                   .astype(np.float32), 5.0)
    assert rsp.signal_dbm == pytest.approx(floor + 6.0, abs=1.5)
    payload = rng.integers(0, 256, (1, g.frame_bytes)).astype(np.uint8)
    pb = TxChain(g, device="cpu").transmit(
        torch.from_numpy(payload)).numpy().reshape(-1)
    win = sigma * rng.standard_normal(buf_len).astype(np.float32)
    win[1000:1000 + len(pb)] += pb.astype(np.float32)
    rsp.on_samples(win, 6.0)
    assert rsp.signal_dbm - floor > 15.0
    rsp.snr_local = None
    m = rsp._make_test_connection()
    assert struct.unpack("<f", m.data[1:5])[0] > 10.0


def _golden_bytes(golden, name):
    return bytes(golden(name).astype(np.uint8))


def _compat_responder():
    return node.ArqNode("PY2ABC", P.RESPONDER,
                        node.ArqConfig(init_configuration=1,
                                       wire_compat=True), device="cpu")


def test_compat_responder_consumes_stock_session(golden):
    """tests/test_link_interop.py:180: the reference's START_CONNECTION
    bytes, a stock DATA batch (sequence = batch position) and the stock
    duplicate 1-byte BLOCK_END land the stream in fifo_rx once, in order."""
    rsp = _compat_responder()
    rsp._on_frame(_golden_bytes(golden, "link_start_connection_bytes"), 0.0)
    assert rsp.link_status == P.CONNECTED
    assert rsp.destination_call_sign == "PP5XX"
    assert rsp._pending_ack
    chunks = [bytes(range(10)), bytes(range(10, 18))]
    for i, chunk in enumerate(chunks):
        m = P.Message(type=P.DATA_SHORT, id=i, sequence=i,
                      length=len(chunk), data=chunk)
        rsp._on_frame(P.serialize(m, CID), 0.0)
    assert len(rsp._rx_msgs) == 2
    for seq in range(2):
        be = P.Message(type=P.CONTROL, length=1, sequence=seq,
                       data=bytes([P.BLOCK_END]))
        rsp._on_frame(P.serialize(be, CID), 0.0)
    assert bytes(rsp.fifo_rx) == b"".join(chunks)


def test_stock_break_drives_responder_to_ladder_floor(golden):
    """tests/test_wire_compat_matrix.py:77: a connected compat responder
    that hears the reference's own BREAK tone drops to ROBUST_0."""
    rsp = _compat_responder()
    rsp._on_frame(_golden_bytes(golden, "link_start_connection_bytes"), 0.0)
    assert rsp.link_status == P.CONNECTED
    assert rsp.current_configuration != ROBUST_0
    pat = golden("link_break_pattern_passband").astype(np.float32)
    buf = np.zeros(len(pat) + 8000, np.float32)
    buf[2000: 2000 + len(pat)] = pat
    rsp.on_samples(buf, 1.0)
    assert rsp.current_configuration == ROBUST_0
