"""ARQ node: commander/responder state machines over the batched PHY.

Wire-compatible with the reference's data-link layer (frame headers,
START_CONNECTION handshake with callsign CRC8, SET_CONFIG gearshift with
forward/reverse configs, pattern ACKs, selective ACK_MULTI/ACK_RANGE frames,
BREAK emergency drop — source/datalink_layer/arq_*.cc):

- Complete data blocks are acknowledged with the tone pattern (fast, 1.45 s,
  config-independent — arq_responder.cc:429-485).
- Partial blocks are acknowledged with an LDPC-framed ACK_MULTI (or
  ACK_RANGE when contiguous) listing the message ids actually received
  (arq_responder.cc:487-631), sent at the robust ack configuration; the
  commander then retransmits ONLY the missing messages
  (arq_commander.cc:897-1133 register_ack loop).
- Gearshift: frame-level up after N consecutive clean block ACKs
  (threshold doubling when a fresh upshift immediately fails —
  arq_commander.cc:1000-1010), success-rate-based one-step downshift when a
  block needed resends for >55% of its frames (datalink_config.cc:48-49
  down threshold 45% success), and a progressive BREAK ladder (drop 1,2,4…
  steps, arq_commander.cc:42-187) with post-BREAK SET_CONFIG recovery to the
  target config instead of re-climbing from the floor.
- TEST_CONNECTION carries the sender's measured SNR and is answered with an
  LDPC ACK_CONTROL frame carrying the receiver's measured SNR
  (arq_commander.cc:307-318, arq_responder.cc:682-697); the SNR seeds
  turboshift candidates via the get_configuration ladder
  (telecom_system.cc:3036-3106).

The node is clock-agnostic: `poll(now_ms)` advances timers and returns
passband blocks to transmit; `on_samples()` delivers capture audio. The
simulation harness (link.sim) drives two nodes through the channel model with
a simulated clock; a real-time transport can drive the same node off a sound
card or socket.

PyTorch port of the JAX package's `link/node.py`: the state machine is the
same line for line; the PHY chains are the port's and run on the CUDA card
unless `device` names another (convert.resolve_device). Samples in and
passbands out stay numpy on the host; each receive's results reach the host
in one copy (`convert.host_rows`).
"""

from __future__ import annotations

import dataclasses
import struct
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from mercury_tpu_torch.convert import host_rows, resolve_device
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.core.modes import (ROBUST_0, get_configuration,
                                          ladder_down, ladder_index,
                                          ladder_up)
from mercury_tpu_torch.link import protocol as P
from mercury_tpu_torch.modem.patterns import PatternSignaler
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

CONFIG_UNCHANGED = 0xFF     # SET_CONFIG reverse byte: keep current reverse


@dataclass
class ArqConfig:
    """Link defaults (reference: datalink_config.cc:25-65)."""
    init_configuration: int = 0
    ack_configuration: int = 0
    gear_shift_on: bool = True
    robust_enabled: bool = True
    batch_size: int = 5
    n_messages: int = 20
    n_resends: int = 20
    link_timeout_ms: int = 30000
    ptt_on_delay_ms: int = 100
    ptt_off_delay_ms: int = 200
    frame_shift_threshold: int = 3
    emergency_nack_threshold: int = 2
    # success-rate ladder thresholds (datalink_config.cc:48-49)
    gear_shift_down_success_rate: float = 45.0
    turboshift: bool = False      # probe the ladder upward right after connect
    rx_profile: str = "static"    # "track" = fading-tracking receiver
                                  # (decision-directed, docs/fading_r2.md)
    carrier_offset_hz: float = 0.0  # radio-type passband shift: 15000.0 for
                                    # sBitx (reference main.cc:200-218)
    ldpc_max_iter: int = 50         # BP iteration cap (INI LDPCIterationsMax)
    # stock-Mercury wire compatibility: emit exactly the reference's framing
    # (tests/test_link_interop.py proves byte-identity against frames dumped
    # from the reference's own serializer). Differences vs the repo's native
    # framing: control frames sent in duplicate (reference
    # control_batch_size=2, datalink_config.cc:58 — a stock responder only
    # processes a control at sequence >= control_batch_size-1), DATA
    # sequence = batch position (arq_common.cc:2161), BLOCK_END as a
    # separate 1-byte control after the data ack (arq_commander.cc:1616-1620)
    # instead of riding the batch with count+offset, 3-byte SET_CONFIG, and
    # pattern acks for controls instead of ACK_CONTROL+SNR frames. The
    # RECEIVE side accepts both framings regardless of this flag, except
    # SET_CONFIG, whose stock and extended payloads are indistinguishable
    # after PHY zero-padding — there the flag decides the parse. Turboshift
    # is forced off under compat (its probe flow uses extended SET_CONFIG).
    wire_compat: bool = False


@dataclass
class LinkStats:
    sent_data: int = 0
    acked_data: int = 0
    received_data: int = 0
    resent_data: int = 0
    blocks_sent: int = 0
    blocks_acked: int = 0
    gearshift_ups: int = 0
    gearshift_downs: int = 0
    breaks_sent: int = 0
    selective_acks_sent: int = 0
    selective_acks_received: int = 0


class _PhyCache:
    """Per-(config, rx_profile, device) PHY chain cache shared between nodes
    in one process. profile "track" swaps in the fading-tracking receiver
    (time-localized pilot LS + decision-directed re-estimation,
    docs/fading_r2.md) — RX-side only, wire-identical TX. Nodes driven from
    several threads (ArqTcpServer) share the chains; the lock keeps two
    threads from building one entry twice."""
    _cache: dict = {}
    _lock = threading.Lock()

    @classmethod
    def get(cls, cfg: int, profile: str = "static",
            carrier_offset_hz: float = 0.0, ldpc_max_iter: int = 50,
            device=None):
        dev = resolve_device(device)
        key = (cfg, profile, carrier_offset_hz, ldpc_max_iter, dev)
        with cls._lock:
            if key not in cls._cache:
                off = carrier_offset_hz
                if (profile == "track"
                        and not build_geometry(cfg).spec.is_mfsk):
                    g = build_geometry(cfg, ls_window=(5, 21),
                                       carrier_offset_hz=off)
                    rx = RxChain(g, device=dev, dd=True, dd_window=(5, 9),
                                 dd_passes=2, ldpc_max_iter=ldpc_max_iter)
                else:
                    g = build_geometry(cfg, carrier_offset_hz=off)
                    rx = RxChain(g, device=dev, ldpc_max_iter=ldpc_max_iter)
                cls._cache[key] = (g, TxChain(g, device=dev), rx,
                                   PatternSignaler(g, device=dev))
            return cls._cache[key]


class ArqNode:
    """One end of an ARQ link. Its PHY chains run on the CUDA card unless
    `device` names another (device="cpu" for the plain versions)."""

    def __init__(self, call_sign: str, role: int,
                 config: ArqConfig | None = None,
                 on_event: Callable[[str], None] | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = config or ArqConfig()
        if self.cfg.wire_compat and self.cfg.turboshift:
            # the turboshift probe flow rides the extended SET_CONFIG
            # payload; a stock peer cannot follow it
            self.cfg = dataclasses.replace(self.cfg, turboshift=False)
        self.call_sign = call_sign.upper()
        self.role = role
        self.on_event = on_event or (lambda s: None)
        self.stats = LinkStats()

        self.link_status = P.LISTENING if role == P.RESPONDER else P.IDLE
        self.connection_status = P.IDLE
        self.connection_id = P.BROADCAST_ID
        self.destination_call_sign = ""

        self.fifo_tx = bytearray()
        self.fifo_rx = bytearray()

        # --- PHY chains (current data config + fixed ack config)
        self.current_configuration: int | None = None
        self._block_msgs: list[P.Message] = []
        self._rx_msgs: dict[int, P.Message] = {}
        self._set_config(self.cfg.init_configuration)
        (self._ack_geom, self._ack_tx, self._ack_rx,
         _unused) = _PhyCache.get(self.cfg.ack_configuration,
                                  self.cfg.rx_profile,
                                  self.cfg.carrier_offset_hz,
                                  self.cfg.ldpc_max_iter, self.device)
        self._ack_buf_len = (self._ack_geom.nofdm * self._ack_geom.buffer_nsymb
                             * self._ack_geom.interp)
        self._ack_max_data = self._ack_geom.frame_bytes - P.MAX_HEADER_LEN

        # --- commander TX / block state
        self._await_ack_kind: str | None = None   # 'data' | 'control'
        self._await_deadline = 0.0
        self._pending_control: P.Message | None = None
        self._resends_left = self.cfg.n_resends
        self._tried_repeat = False
        self._tx_off = 0              # stream offset of fifo_tx[0]
        self._block_off = 0           # stream offset of current block start
        self._block_seq = 0           # per-block sequence (mod 256)
        self._block_sent_once = False
        self._blk_sent = 0            # frames sent for current block (incl. resends)
        self._blk_resent = 0
        self._resume_connect = False

        # --- gearshift state
        self.consecutive_data_acks = 0
        self.frame_shift_threshold = self.cfg.frame_shift_threshold
        self._gear_pending: int | None = None     # proposed cfg awaiting ack
        self._gear_request: int | None = None     # queued proposal (any dir)
        self._gear_just_applied = False           # fresh upshift, unproven
        self.emergency_nacks = 0
        self._break_step = 1                      # progressive drop 1,2,4,…
        self._post_break_target: int | None = None
        self._gear_recovering = False             # SET_CONFIG is post-BREAK
        # forward (this node TX -> peer) / reverse (peer TX -> this node)
        # asymmetric configs (reference SET_CONFIG data[1]/data[2],
        # arq_commander.cc:319-341, arq_responder.cc:717-744)
        self.forward_configuration = self.cfg.init_configuration
        self.reverse_configuration: int | None = None

        # --- SNR measurements (reference st_measurements, arq.h:134-140)
        self.snr_local: float | None = None   # SNR of frames we decode
        self.snr_remote: float | None = None  # SNR the peer reports hearing us
        # idle-channel signal measurement (reference signal_stregth_dbm,
        # arq_common.cc:1714-1736): signal_dbm = last measured window;
        # noise_floor_dbm = EMA over windows seen while LISTENING/IDLE
        self.signal_dbm: float | None = None
        self.noise_floor_dbm: float | None = None
        self.processing_load: float | None = None  # proc_time/audio_time

        # --- turboshift probe state (reference: arq_commander.cc:1135-1167;
        # desync-safe variant — see _poll_turbo)
        self._turbo_active = False
        self._turbo_rendezvous = self.cfg.init_configuration
        self._turbo_candidate: int | None = None
        self._turbo_stage: str | None = None      # 'snr' | 'set' | 'test'
        self._turbo_seeded = False                # candidate from SNR map
        self._turbo_wait_until: float | None = None  # peer-revert resync
        self._probe_deadline: float | None = None  # responder-side revert
        self._probe_revert_cfg: int | None = None

        # --- responder RX / ack state
        self._rx_off = 0              # delivered-stream offset
        self._rx_block_seq = -1       # sequence of the partial block in _rx_msgs
        self._had_acked_block = False
        self._last_ack_multi: P.Message | None = None
        self._pending_ack = False     # queue the tone pattern
        self._pending_new_config: int | None = None
        self._pending_probe_revert: int | None = None
        self._pending_reverse_cfg: int | None = None
        self._pending_role: int | None = None
        self._pending_ack_frame: P.Message | None = None  # LDPC-framed ack

        self._last_peer_activity: float | None = None
        self._last_now = 0.0

    # ------------------------------------------------------------------
    def _requeue_block(self) -> None:
        """Push un-delivered block data back to the front of the TX FIFO so it
        is re-framed for the (possibly different) new frame size (reference
        push_front restore, arq_commander.cc:1113-1120). ACKED-but-undelivered
        messages are restored too: the responder only delivers complete
        blocks and clears partials on any config switch."""
        if self._block_msgs:
            restored = b"".join(m.data[: m.length] for m in self._block_msgs)
            self.fifo_tx[:0] = restored
            self._block_msgs = []
        self._block_sent_once = False

    def _set_config(self, config: int) -> None:
        if self.current_configuration == config:
            return
        self._requeue_block()
        if self._rx_msgs:
            self._rx_msgs.clear()   # partial frames of the old config are void
        self.current_configuration = config
        g, tx, rx, pat = _PhyCache.get(config, self.cfg.rx_profile,
                                       self.cfg.carrier_offset_hz,
                                       self.cfg.ldpc_max_iter, self.device)
        self.geom, self._tx, self._rx, self._pat = g, tx, rx, pat
        self.max_data_length = g.frame_bytes - P.MAX_HEADER_LEN
        self.frame_ms = 1000.0 * g.total_frame_size / g.fs
        self.ack_pattern_ms = 1000.0 * self._pat.passband_samples / g.fs
        # ack timeout covers batch TX + pattern + PTT turnarounds
        # (reference: arq_common.cc:715-725)
        self.ack_timeout_ms = ((self.cfg.batch_size + 1) * self.frame_ms
                               + self.ack_pattern_ms
                               + 4 * self.cfg.ptt_on_delay_ms
                               + 4 * self.cfg.ptt_off_delay_ms + 1500)

    # ------------------------------------------------------------------
    # application API
    def send_data(self, data: bytes) -> None:
        self.fifo_tx.extend(data)

    def received(self) -> bytes:
        out = bytes(self.fifo_rx)
        self.fifo_rx.clear()
        return out

    def connect(self, destination: str) -> None:
        assert self.role == P.COMMANDER
        self.destination_call_sign = destination.upper()
        self.link_status = P.CONNECTING
        self._tx_off = 0                 # fresh stream
        self._resume_connect = False

    # ------------------------------------------------------------------
    # modulation helpers
    def _modulate_batch(self, messages: list[P.Message]) -> np.ndarray:
        """Serialize messages and modulate them into one passband block
        (batch-overlap TX filtering, reference send_batch)."""
        frames = []
        for m in messages:
            payload = P.serialize(m, self.connection_id)
            buf = np.zeros(self.geom.frame_bytes, dtype=np.uint8)
            buf[: len(payload)] = np.frombuffer(payload, np.uint8)
            frames.append(buf)
        batch = torch.from_numpy(np.stack(frames))
        pb = self._tx.transmit_batch(batch).cpu().numpy()
        return pb.reshape(-1)

    def _modulate_control(self, msg: P.Message) -> np.ndarray:
        """Modulate a control message. In wire-compat mode, send the stock
        duplicate pair (control_batch_size=2, sequence = batch position —
        a stock responder waits for sequence >= control_batch_size-1 before
        processing, arq_responder.cc:163-178)."""
        if self.cfg.wire_compat:
            return self._modulate_batch(
                [dataclasses.replace(msg, sequence=i) for i in range(2)])
        return self._modulate_batch([msg])

    def _modulate_ack_frame(self, msg: P.Message) -> np.ndarray:
        """One LDPC frame at the robust ack configuration (the reference
        sends ACK_MULTI batches at ack_configuration,
        arq_responder.cc:556-568)."""
        payload = P.serialize(msg, self.connection_id)
        buf = np.zeros(self._ack_geom.frame_bytes, dtype=np.uint8)
        buf[: len(payload)] = np.frombuffer(payload, np.uint8)
        pb = self._ack_tx.transmit_batch(torch.from_numpy(buf[None]))
        return pb.cpu().numpy().reshape(-1)

    def _start_wait(self, kind: str, now: float) -> None:
        self._await_ack_kind = kind
        self._await_deadline = now + self.ack_timeout_ms

    # ------------------------------------------------------------------
    # capture handling
    def _measure_idle(self, samples: np.ndarray, update_floor: bool) -> None:
        """Signal-strength measurement on a capture window (reference idle
        measurement, arq_common.cc:1714-1736). Updates signal_dbm always;
        folds the window into the noise-floor EMA when the link state says
        the channel should be idle."""
        dbm = float(self._rx.measure_signal_dbm(
            samples[None].astype(np.float32)).cpu()[0])
        self.signal_dbm = dbm
        if update_floor:
            if self.noise_floor_dbm is None:
                self.noise_floor_dbm = dbm
            else:
                self.noise_floor_dbm += 0.2 * (dbm - self.noise_floor_dbm)

    def on_samples(self, samples: np.ndarray, now: float) -> None:
        """Deliver a received passband block; the node decodes according to
        its state."""
        import time as _time
        _t0 = _time.perf_counter()
        try:
            self._on_samples(samples, now)
        finally:
            # processing-load ratio proc_time/audio_time (reference
            # arq_common.cc:2667-2686, surfaced to the GUI via
            # gui_state.h:118-119); >1 means the decoder cannot keep up
            # with the real-time sample rate
            audio_s = len(samples) / 48000.0
            if audio_s > 0:
                self.processing_load = (_time.perf_counter() - _t0) / audio_s

    def _pattern_hit(self, detector, samples: np.ndarray) -> bool:
        """Tone-pattern decision: metric >= threshold AND matched symbols
        >= NSYMB/2 (reference arq_common.cc:2582-2583 / 2861-2862). The
        matched-count gate is load-bearing: the g=5/g=7 Welch-Costas ACK
        and BREAK sequences collide at 2 of 16 hop positions ((5*7^-1)^p
        = 8^p = 1 mod 17 at p=0,8), so the CROSS pattern scores metric
        ~1.0 >= both thresholds at high SNR — but only ~2 matched
        symbols. Measured: docs/pattern_detect_r5.json (metric-only
        cross-detection Pdet hits 1.0 above -1 dB; the gate zeroes it
        while leaving the true-pattern waterfall unchanged)."""
        metric, matched = host_rows(*detector(samples[None]))[0]
        return (float(metric) >= self._pat.threshold
                and int(matched)
                >= self._pat.ack_mfsk.ack_pattern_nsymb // 2)

    def _on_samples(self, samples: np.ndarray, now: float) -> None:
        self._last_now = now
        if self.link_status in (P.LISTENING, P.IDLE, P.DROPPED):
            # idle channel: this window is the noise floor (reference
            # measures exactly in these states, arq_common.cc:1714)
            self._measure_idle(samples, update_floor=True)
        if self._await_ack_kind is not None:
            # expecting an ACK: tone pattern first (cheap, config-independent)
            if self._pattern_hit(self._pat.detect_ack, samples):
                self._on_ack_pattern(now)
                return
            # BREAK while waiting
            if self._pattern_hit(self._pat.detect_break, samples):
                self._on_break_detected(now)
                return
            # LDPC-framed ack (ACK_MULTI / ACK_RANGE / ACK_CONTROL) at the
            # ack configuration
            msg = self._try_decode_ack_frame(samples)
            if msg is not None:
                self._on_ack_frame(msg, now)
            return

        if self.role == P.RESPONDER or self.link_status == P.CONNECTED:
            decoded_before = self.stats.received_data
            got_ctrl = self._receive_frames(samples, now)
            if (self.cfg.wire_compat and self.role == P.RESPONDER
                    and self.stats.received_data > decoded_before
                    and self._rx_window_all_decoded):
                # stock flow: the responder pattern-acks a received data
                # batch on its own (arq_responder.cc:429-485) — BLOCK_END
                # arrives later as a separate control, so the batch itself
                # carries nothing to trigger the ack. Only a FULLY decoded
                # window is acked: the stock pattern ack carries no ids, so
                # acking a partial batch makes the commander mark every
                # frame delivered and silently lose the missing ones
                # (genuine stock data-loss flaw); staying silent instead
                # routes recovery through the resend machinery
                self._queue_pattern_ack(now)
            if (self.role == P.RESPONDER
                    and self.stats.received_data == decoded_before
                    and not got_ctrl):
                # nothing decoded — check for an emergency BREAK pattern
                # (reference: arq_common.cc:2855-2869)
                if self._pattern_hit(self._pat.detect_break, samples):
                    self._on_break_detected(now)
                else:
                    # undecodable window while connected: signal strength is
                    # the only evidence this channel state produces
                    self._measure_idle(samples, update_floor=False)

    def _try_decode_ack_frame(self, samples: np.ndarray) -> P.Message | None:
        """Attempt to decode one frame at the ack configuration."""
        buf = np.zeros(self._ack_buf_len, dtype=np.float32)
        n = min(len(samples), self._ack_buf_len)
        buf[:n] = samples[:n]
        res = self._ack_rx.receive(buf[None])
        row = host_rows(res.crc_ok, res.snr_db, res.payload)[0]
        if not row[0]:
            return None
        # an ack frame is a frame from the peer: its post-equalization SNR is
        # a valid downlink measurement (feeds get_configuration seeding)
        self.snr_local = float(row[1])
        return P.deserialize(bytes(row[2:].astype(np.uint8)),
                             self._ack_max_data)

    def _receive_frames(self, samples: np.ndarray, now: float) -> bool:
        """Decode every frame in a delivered block: run full sync on a window
        containing one frame slot (the Schmidl-Cox argmax is ambiguous when
        several back-to-back frames sit in one window), then batch-decode ALL
        frame slots at their contiguous offsets in one jitted call. The sync
        anchor is the first DECODABLE frame, not frame 0 — a lost leading
        frame must not mask the rest of the batch (the selective-ACK path
        depends on the surviving frames being delivered).
        Returns True when at least one frame decoded."""
        g = self.geom
        buf_len = g.nofdm * g.buffer_nsymb * g.interp
        frame_len = g.total_frame_size
        n_frames = int(round(len(samples) / frame_len))
        self._rx_window_all_decoded = False
        if n_frames < 1:
            return False

        anchor = None
        res0 = None
        for k0 in range(n_frames):
            first = np.zeros(buf_len, dtype=np.float32)
            chunk = samples[k0 * frame_len: (k0 + 1) * frame_len]
            first[: len(chunk)] = chunk
            res = self._rx.receive(first[None])
            res0 = host_rows(res.crc_ok, res.delay, res.snr_db,
                             res.freq_offset, res.payload)[0]
            if res0[0]:
                anchor = k0
                break
        if anchor is None:
            return False
        _ok, delay0, snr0, freq0 = res0[:4]
        payload0 = bytes(res0[4:].astype(np.uint8))
        t0 = int(delay0) + 8   # undo the early-sampling bias
        self.snr_local = float(snr0)
        if n_frames == 1:
            self._rx_window_all_decoded = True
            self._on_frame(payload0, now)
            return True

        base = anchor * frame_len + t0        # absolute start of the anchor
        # sibling frames re-sync individually within +-margin of their
        # nominal frame_len slots (known-preamble matched filter): a
        # transport that pads, coalesces or drifts between frames cannot
        # break the fixed-slot assumption (reference drift tolerance:
        # arq_common.cc:2690-2730)
        margin = 256
        rows = np.zeros((n_frames, buf_len), dtype=np.float32)
        for k in range(n_frames):
            start = base + (k - anchor) * frame_len - margin
            off = max(0, -start)
            src = samples[max(start, 0): start + buf_len]
            rows[k, off: off + len(src)] = src
        delays = np.full(n_frames, margin, dtype=np.int32)
        freqs = np.full(n_frames, freq0, dtype=np.float32)
        payloads, crc_ok, _i, _s, _mh, _d, _score = self._rx.refine_decode(
            rows, delays, freqs, margin)
        host = host_rows(crc_ok, payloads)
        ok = host[:, 0].astype(bool)
        pl = host[:, 1:].astype(np.uint8)
        self._rx_window_all_decoded = bool(ok.all())
        for k in range(n_frames):
            if ok[k]:
                self._on_frame(bytes(pl[k]), now)
        return True

    # ------------------------------------------------------------------
    # frame/state handling
    def _on_frame(self, payload: bytes, now: float) -> None:
        msg = P.deserialize(payload, self.max_data_length)
        if msg is None:
            return
        # ANY decoded frame from the peer refreshes the link timer — without
        # this, a long control-only phase (turboshift climb, gearshift
        # negotiation) trips the 30 s supervision timeout mid-session
        self._last_peer_activity = now
        # ... and cancels a pending config revert: the revert exists only for
        # "the commander never heard my SET_CONFIG ack and stayed on the old
        # config" — a frame decoded at the NEW config proves it switched
        self._probe_deadline = None
        self._probe_revert_cfg = None
        if msg.type in (P.DATA_LONG, P.DATA_SHORT):
            if self.link_status == P.CONNECTED:
                # a stock commander numbers frames by batch position
                # (arq_common.cc:2161), so sequence carries no block
                # identity there — block boundaries come from BLOCK_END
                if (not self.cfg.wire_compat
                        and msg.sequence != self._rx_block_seq):
                    # a new block started: stale partials of the previous
                    # block must not satisfy this block's BLOCK_END count
                    self._rx_msgs.clear()
                    self._rx_block_seq = msg.sequence
                self._rx_msgs[msg.id] = msg
                self.stats.received_data += 1
                # a fresh/resent block invalidates the repeatable last ACK
                self._had_acked_block = False
        elif msg.type == P.CONTROL:
            self._on_control(msg, now)

    def _on_control(self, msg: P.Message, now: float) -> None:
        code = msg.data[0]
        if code == P.START_CONNECTION and self.role == P.RESPONDER \
                and self.link_status in (P.LISTENING, P.CONNECTION_RECEIVED,
                                         P.CONNECTED):
            # CONNECTED case: the commander timed out and is re-connecting
            # (reference link-timeout auto-reconnect) — re-sync instead of
            # ignoring it, or the two ends deadlock until our own timeout
            if msg.data[1] == P.crc8(self.call_sign.encode()):
                self.destination_call_sign = P.callsign_unpack(msg.data[2:7])
                self._rx_msgs.clear()
                self._rx_block_seq = -1
                self._had_acked_block = False
                self._last_ack_multi = None
                if msg.sequence == 0:      # fresh session (not a reconnect)
                    self._rx_off = 0
                self.link_status = P.CONNECTED
                self._last_peer_activity = now
                self.on_event(f"CONNECTED {self.destination_call_sign}")
                self._queue_pattern_ack(now)
        elif code == P.BLOCK_END and self.role == P.RESPONDER \
                and self.link_status == P.CONNECTED:
            self._on_block_end(msg, now)
        elif code == P.TEST_CONNECTION and self.link_status == P.CONNECTED:
            self._probe_deadline = None       # probe frame decoded: success
            if len(msg.data) >= 5:
                # the probe carries the peer's measured SNR of OUR frames
                # (reference: arq_commander.cc:307-318)
                snr = struct.unpack("<f", msg.data[1:5])[0]
                if snr > -90.0:
                    self.snr_remote = snr
            # answer with an ACK_CONTROL frame carrying our measured SNR
            # (reference: arq_responder.cc:682-697); a stock peer expects
            # the tone-pattern ack instead (arq_responder.cc:203-216)
            if self.cfg.wire_compat:
                self._queue_pattern_ack(now)
            else:
                self._queue_ack_control(P.TEST_CONNECTION)
        elif code == P.SET_CONFIG and self.role == P.RESPONDER:
            fwd = msg.data[1]
            self._queue_pattern_ack(now, new_config=fwd)
            if self.cfg.wire_compat:
                # stock payload [code, forward, reverse]
                # (arq_commander.cc:319-341): data[2] is the reverse config
                # (our TX direction after a role switch); there is no revert
                # byte on the stock wire, so revert to the pre-switch config
                # if the commander never confirms. PHY zero-padding makes
                # stock and extended payloads indistinguishable on the wire,
                # hence the flag decides the parse here.
                self._pending_probe_revert = self.current_configuration
                self._pending_reverse_cfg = int(msg.data[2])
            else:
                # every config switch (gearshift or turbo probe) arms the
                # revert deadline: if our ACK is lost the commander stays on
                # the old config, and without a revert the two ends desync
                # permanently
                self._pending_probe_revert = int(msg.data[2])
                # asymmetric reverse config (the config WE should transmit
                # at after a role switch — arq_responder.cc:717-744)
                if len(msg.data) >= 5 and msg.data[4] != CONFIG_UNCHANGED:
                    self._pending_reverse_cfg = int(msg.data[4])
        elif code == P.SWITCH_ROLE and self.role == P.RESPONDER \
                and self.link_status == P.CONNECTED:
            # become the commander after acking (reference:
            # arq_responder.cc:764-770, arq_commander.cc turboshift/finish);
            # the message carries the reverse config we should transmit at,
            # making the asymmetric-config switch atomic on one message
            if len(msg.data) >= 2 and msg.data[1] != CONFIG_UNCHANGED:
                self.reverse_configuration = int(msg.data[1])
            self._queue_pattern_ack(now)
            self._pending_role = P.COMMANDER
        elif code == P.KEEP_ALIVE and self.link_status == P.CONNECTED:
            self._last_peer_activity = now
            self._queue_pattern_ack(now)
        elif code == P.REPEAT_LAST_ACK and self.role == P.RESPONDER:
            # the commander missed our ACK — repeat the pattern only if we
            # actually ACKed the last block (reference: repeating_last_ack,
            # arq_responder.cc:797-801); a partial block repeats its
            # selective ACK frame (reference messages_last_ack_bu,
            # arq_responder.cc:490-512); otherwise stay silent so the
            # commander's next timeout triggers a data resend
            if self._had_acked_block:
                self._queue_pattern_ack(now)
            elif self._last_ack_multi is not None:
                self._pending_ack_frame = self._last_ack_multi
        elif code in (P.FILE_START, P.FILE_END_, P.PIPE_OPEN, P.PIPE_CLOSE) \
                and self.role == P.RESPONDER and self.link_status == P.CONNECTED:
            name = {P.FILE_START: "FILE START", P.FILE_END_: "FILE END",
                    P.PIPE_OPEN: "PIPE OPEN", P.PIPE_CLOSE: "PIPE CLOSE"}[code]
            self.on_event(name)
            self._queue_pattern_ack(now)
        elif code == P.CLOSE_CONNECTION:
            self._queue_pattern_ack(now)
            self.link_status = P.DISCONNECTING
            self.on_event("DISCONNECTED")

    def _on_block_end(self, msg: P.Message, now: float) -> None:
        if msg.length < 2 or msg.data[1] == 0:
            # stock BLOCK_END (reference add_message_control generic branch:
            # 1 byte, no count/offset — PHY zero-padding then makes data[1]
            # read 0, which an extended BLOCK_END never carries: its count
            # is always >= 1). Stock semantics: deliver every
            # received message of the block in id order and ack — the stock
            # commander only sends BLOCK_END once the whole block is acked
            # (arq_commander.cc:1616-1620, copy_data_to_buffer
            # arq_common.cc). No stream-offset dedupe is possible here; a
            # resent stock BLOCK_END after our lost ack re-acks the (now
            # empty) block without duplicating delivery.
            if self._rx_msgs:
                for i in sorted(self._rx_msgs):
                    m = self._rx_msgs[i]
                    self.fifo_rx.extend(m.data[: m.length])
                self._rx_msgs.clear()
                self._had_acked_block = True
                self._last_ack_multi = None
            self._queue_pattern_ack(now)
            return
        expected = msg.data[1]
        off = int.from_bytes(msg.data[2:6], "little") if len(msg.data) >= 6 else 0
        if msg.sequence != self._rx_block_seq:
            # BLOCK_END of a block we received nothing of: partials in
            # _rx_msgs belong to an older block — void them, stay silent
            self._rx_msgs.clear()
            self._rx_block_seq = msg.sequence
            return
        have_all = expected > 0 and all(i in self._rx_msgs
                                        for i in range(expected))
        if have_all:
            # Dedupe by STREAM BYTE OFFSET, not sequence number: an offset
            # survives resends, link-timeout reconnects, and config changes
            # that reframe the same bytes — a sequence number does not
            blob = b"".join(self._rx_msgs[i].data[: self._rx_msgs[i].length]
                            for i in range(expected))
            end = off + len(blob)
            if end <= self._rx_off:
                pass                      # pure duplicate: re-ACK only
            elif off <= self._rx_off:
                self.fifo_rx.extend(blob[self._rx_off - off:])  # new tail only
                self._rx_off = end
            else:
                # offset gap: we are a fresh responder joining a resumed
                # stream — accept from here
                self.fifo_rx.extend(blob)
                self._rx_off = end
            self._rx_msgs.clear()
            self._had_acked_block = True
            self._last_ack_multi = None
            self._queue_pattern_ack(now)
        else:
            # partial block: selective-ACK the ids we DID receive so the
            # commander resends only the missing ones
            # (reference ACK_MULTI, arq_responder.cc:487-631)
            got = sorted(i for i in self._rx_msgs if i < expected)
            if got:
                self._queue_selective_ack(got, msg.sequence)
            # nothing received: stay silent; the commander's ack timeout
            # (REPEAT_LAST_ACK → full resend) covers it

    def _queue_selective_ack(self, ids: list[int], seq: int) -> None:
        ids = ids[: max(self._ack_max_data - 1, 0)]
        if len(ids) >= 2 and ids == list(range(ids[0], ids[-1] + 1)):
            m = P.Message(type=P.ACK_RANGE, sequence=seq, length=2,
                          data=bytes([ids[0], ids[-1]]))
        else:
            m = P.Message(type=P.ACK_MULTI, sequence=seq, length=1 + len(ids),
                          data=bytes([len(ids)] + ids))
        self._pending_ack_frame = m
        self._last_ack_multi = m
        self._had_acked_block = False
        self.stats.selective_acks_sent += 1

    def _queue_ack_control(self, code: int) -> None:
        snr = self.snr_local if self.snr_local is not None else -99.9
        m = P.Message(type=P.ACK_CONTROL, length=5,
                      data=bytes([code]) + struct.pack("<f", float(snr)))
        self._pending_ack_frame = m

    def _queue_pattern_ack(self, now: float, new_config: int | None = None) -> None:
        self._pending_ack = True
        self._pending_new_config = new_config

    # ------------------------------------------------------------------
    # commander-side ack handling
    def _on_ack_pattern(self, now: float) -> None:
        kind = self._await_ack_kind
        self._await_ack_kind = None
        self._last_peer_activity = now
        if kind == "data":
            if self._tried_repeat:
                # ambiguous: the pattern answers our REPEAT_LAST_ACK, which
                # re-ACKs the last block the responder DELIVERED — if our
                # current block was lost entirely, that is the PREVIOUS
                # block, and treating it as an ACK would silently drop data.
                # Resend the current block under the same sequence number:
                # the responder dedupes it if it did deliver it.
                # (emergency_nacks is NOT reset: if the data path stays dead
                # while ACKs get through, the BREAK ladder still escalates.)
                self._tried_repeat = False
                self._resends_left = self.cfg.n_resends
                return
            if self.cfg.wire_compat:
                # stock flow: the pattern acks the data frames; block
                # completion happens on the BLOCK_END control's ack
                # (arq_commander.cc:1288-1301)
                for m in self._block_msgs:
                    m.status = P.ACKED
                self._pending_control = P.Message(
                    type=P.CONTROL, length=1, data=bytes([P.BLOCK_END]))
                return
            self._complete_block(now)
        elif kind == "control":
            self._control_acked(now)

    def _on_ack_frame(self, msg: P.Message, now: float) -> None:
        """An LDPC-framed ACK decoded while waiting (ACK_MULTI/ACK_RANGE for
        data, ACK_CONTROL for control probes)."""
        kind = self._await_ack_kind
        if msg.type in (P.ACK_MULTI, P.ACK_RANGE) and kind == "data":
            if (not self.cfg.wire_compat
                    and msg.sequence != (self._block_seq & 0xFF)):
                return   # stale ack of an older block (stock acks carry the
                # batch position in sequence instead, arq_responder.cc:523)
            if msg.type == P.ACK_RANGE:
                ids = set(range(msg.data[0], msg.data[1] + 1))
            else:
                n = min(msg.data[0], msg.length - 1)
                ids = set(msg.data[1: 1 + n])
            self._await_ack_kind = None
            self._last_peer_activity = now
            self._tried_repeat = False
            self.stats.selective_acks_received += 1
            for m in self._block_msgs:
                if m.id in ids:
                    m.status = P.ACKED
            missing = [m for m in self._block_msgs if m.status != P.ACKED]
            if not missing:
                self._complete_block(now)
            else:
                # next poll() resends exactly the missing messages
                self._resends_left -= 1
                if self._resends_left <= 0:
                    self.link_status = P.DROPPED
                    self.on_event("LINK FAILED")
        elif msg.type == P.ACK_CONTROL and kind == "control":
            code = msg.data[0] if msg.length >= 1 else None
            pend = self._pending_control.data[0] if self._pending_control else None
            if code != pend:
                return
            if msg.length >= 5:
                snr = struct.unpack("<f", msg.data[1:5])[0]
                if snr > -90.0:
                    self.snr_remote = snr
            self._await_ack_kind = None
            self._last_peer_activity = now
            self._control_acked(now)

    def _complete_block(self, now: float) -> None:
        """Whole block delivered and acknowledged."""
        self._tx_off = self._block_off + sum(m.length for m in self._block_msgs)
        n = len(self._block_msgs)
        self.stats.acked_data += n
        self._block_msgs = []
        self._block_sent_once = False
        self.stats.blocks_acked += 1
        self.emergency_nacks = 0
        self._break_step = 1
        self._gear_just_applied = False   # the new config carried a block
        self._tried_repeat = False
        self._resends_left = self.cfg.n_resends
        # success-rate gearshift (reference: arq_commander.cc:1302-1380,
        # thresholds datalink_config.cc:48-49). nSent counts FIRST sends
        # only, nReSent counts retransmissions (arq_commander.cc:512-537):
        # success = 100*(1 - resent/first_sent) — one resend round of 2/3
        # messages already reads 33%.
        sent, resent = self._blk_sent, self._blk_resent
        success = 100.0 * (1.0 - resent / max(sent, 1))
        if resent == 0:
            self.consecutive_data_acks += 1
        else:
            self.consecutive_data_acks = 0
            if (self.cfg.gear_shift_on
                    and success < self.cfg.gear_shift_down_success_rate):
                down = ladder_down(self.current_configuration, 1,
                                   self.cfg.robust_enabled)
                if down != self.current_configuration:
                    self._gear_request = down

    def _control_acked(self, now: float) -> None:
        """The pending control message was acknowledged (pattern or frame)."""
        code = (self._pending_control.data[0]
                if self._pending_control else None)
        if code == P.START_CONNECTION:
            self.link_status = P.CONNECTED
            self.on_event(f"CONNECTED {self.destination_call_sign}")
            if self.cfg.turboshift and self.cfg.gear_shift_on:
                self._turbo_begin()
        elif code == P.TEST_CONNECTION and self._turbo_stage == "snr":
            # SNR probe answered: seed the candidate from the measured SNR
            # (reference SNR_BASED get_configuration, telecom_system.cc:3036)
            self._turbo_stage = None
            seed = None
            if self.snr_remote is not None:
                seed = get_configuration(self.snr_remote)
                if (ladder_index(seed) <= ladder_index(self.current_configuration)
                        or seed == self.current_configuration):
                    seed = None
            if seed is not None:
                self._turbo_candidate = seed
                self._turbo_seeded = True
                self.on_event(f"TURBO SEED {seed}")
            else:
                self._turbo_candidate = self._ladder_up()
            if self._turbo_candidate == self._turbo_rendezvous:
                self._turbo_active = False
                self.on_event(f"TURBO DONE {self.current_configuration}")
        elif code == P.SET_CONFIG and self._turbo_stage == "set":
            # turbo probe: responder switched — test at the candidate
            self._set_config(self._turbo_candidate)
            self._turbo_stage = "test"
        elif code == P.TEST_CONNECTION and self._turbo_stage == "test":
            # candidate works: it becomes the new rendezvous
            self._turbo_rendezvous = self._turbo_candidate
            self._turbo_seeded = False        # continue incrementally
            self.stats.gearshift_ups += 1
            self.on_event(f"TURBO OK {self.current_configuration}")
            self._turbo_candidate = self._ladder_up()
            self._turbo_stage = None
            if self._turbo_candidate == self._turbo_rendezvous:
                self._turbo_active = False
                self.on_event(f"TURBO DONE {self.current_configuration}")
        elif code == P.SET_CONFIG and self._gear_pending is not None:
            was_up = (ladder_index(self._gear_pending)
                      > ladder_index(self.current_configuration))
            self._set_config(self._gear_pending)
            self.forward_configuration = self._gear_pending
            data = self._pending_control.data
            if len(data) >= 5 and data[4] != CONFIG_UNCHANGED:
                self.reverse_configuration = int(data[4])
            if self._gear_recovering:
                # post-BREAK recovery jump: the break already counted as the
                # downshift; the target is unproven, so a failed first block
                # steps down one more instead of BREAKing again
                self._gear_recovering = False
                self._gear_just_applied = True
            elif was_up:
                self.stats.gearshift_ups += 1
                self._gear_just_applied = True
            else:
                self.stats.gearshift_downs += 1
            self.on_event(f"GEARSHIFT {self.current_configuration}")
            self._gear_pending = None
            self.consecutive_data_acks = 0
        elif code == P.SWITCH_ROLE:
            self.role = P.RESPONDER
            self._rx_off = 0          # peer starts a fresh TX stream
            self._rx_block_seq = -1
            # asymmetric link: the peer transmits at the reverse config we
            # carried in the SWITCH_ROLE message — listen there
            data = self._pending_control.data
            rev = data[1] if len(data) >= 2 else CONFIG_UNCHANGED
            if rev != CONFIG_UNCHANGED and rev != self.current_configuration:
                self._set_config(int(rev))
                self.on_event(f"REVERSE CONFIG {self.current_configuration}")
            self.on_event("ROLE RESPONDER")
        elif code == P.CLOSE_CONNECTION:
            self.link_status = P.IDLE
            self.on_event("DISCONNECTED")
        elif code == P.BLOCK_END and self._block_msgs:
            # stock two-phase flow (wire_compat): data pattern-acked, then
            # BLOCK_END acked -> the block is complete
            # (arq_commander.cc:1288-1301)
            self._complete_block(now)
        self._pending_control = None
        self._resends_left = self.cfg.n_resends

    def _turbo_begin(self) -> None:
        self._turbo_active = True
        self._turbo_rendezvous = self.current_configuration
        self._turbo_candidate = None
        self._turbo_seeded = False
        self._turbo_wait_until = None
        # if the peer already reported an SNR (e.g. via a prior probe or the
        # SET_CONFIG negotiation), seed immediately; otherwise ask with a
        # TEST_CONNECTION round first
        if self.snr_remote is not None:
            seed = get_configuration(self.snr_remote)
            if ladder_index(seed) > ladder_index(self.current_configuration):
                self._turbo_candidate = seed
                self._turbo_seeded = True
                self.on_event(f"TURBO SEED {seed}")
            else:
                self._turbo_candidate = self._ladder_up()
            self._turbo_stage = None
            if self._turbo_candidate == self._turbo_rendezvous:
                self._turbo_active = False
                return
        else:
            self._turbo_stage = "snr"
        self.on_event("TURBO START")

    def _ladder_floor(self) -> int:
        return ROBUST_0 if self.cfg.robust_enabled else 0

    def _on_break_detected(self, now: float) -> None:
        # responder side of emergency BREAK: drop to the ladder floor for
        # coordination (reference: arq_commander.cc:42-187 BREAK FSM); the
        # commander follows up with SET_CONFIG to the recovery target
        floor = self._ladder_floor()
        if self.current_configuration != floor:
            self._set_config(floor)
            self.on_event(f"BREAK->CONFIG {floor}")

    # ------------------------------------------------------------------
    # main poll: returns list of passband blocks to transmit
    def poll(self, now: float) -> list[np.ndarray]:
        self._last_now = now
        out: list[np.ndarray] = []

        # responder: flush pending pattern ACK
        if self._pending_ack:
            self._pending_ack = False
            out.append(self._pat.ack_passband.astype(np.float32))
            if self._pending_new_config is not None:
                self._set_config(int(self._pending_new_config))
                self.on_event(f"GEARSHIFT {self.current_configuration}")
                self._pending_new_config = None
                if self._pending_reverse_cfg is not None:
                    self.reverse_configuration = self._pending_reverse_cfg
                    self._pending_reverse_cfg = None
                if self._pending_probe_revert is not None:
                    self._probe_revert_cfg = self._pending_probe_revert
                    # must outlast the commander's control-ack timeout plus
                    # the probe frame itself, or the two sides desync
                    self._probe_deadline = (now + self.ack_timeout_ms
                                            + 3 * self.frame_ms + 2000)
                    self._pending_probe_revert = None
            if self._pending_role is not None:
                self.role = self._pending_role
                self._pending_role = None
                if self.role == P.COMMANDER:
                    self._tx_off = 0      # our TX stream starts fresh
                    # the probe revert is a responder mechanism — void it
                    self._probe_deadline = None
                    self._probe_revert_cfg = None
                    # asymmetric link: transmit at the negotiated reverse
                    # config (reference: arq_responder.cc:717-744)
                    if (self.reverse_configuration is not None
                            and self.reverse_configuration
                            != self.current_configuration):
                        self._set_config(self.reverse_configuration)
                        # the SNR-mapped reverse config is unproven in this
                        # direction: treat like a fresh upshift so a failed
                        # first block immediately steps down one instead of
                        # burning the full REPEAT/NACK ladder
                        self._gear_just_applied = True
                        self.on_event(
                            f"REVERSE CONFIG {self.current_configuration}")
                self.on_event(f"ROLE {'COMMANDER' if self.role == P.COMMANDER else 'RESPONDER'}")
                if (self.role == P.COMMANDER and self.cfg.turboshift
                        and self.cfg.gear_shift_on):
                    # reverse-direction probe: this node has never transmitted
                    # data on the link, so the channel in its direction is
                    # untested (HF paths are asymmetric) — probe the ladder
                    # upward exactly like the post-connect turboshift
                    # (reference: arq_commander.cc:1135-1167 runs whenever the
                    # commander role is assumed, not only at connect)
                    self._turbo_begin()
            return out

        # responder: flush pending LDPC-framed ack (selective / control-SNR)
        if self._pending_ack_frame is not None:
            m = self._pending_ack_frame
            self._pending_ack_frame = None
            out.append(self._modulate_ack_frame(m))
            return out

        # responder-side turbo revert: commander fell back to the rendezvous
        if (self._probe_deadline is not None and now > self._probe_deadline):
            self._probe_deadline = None
            if self._probe_revert_cfg is not None:
                self._set_config(self._probe_revert_cfg)
                self.on_event(f"TURBO REVERT {self.current_configuration}")
                self._probe_revert_cfg = None

        # link supervision (reference link_timeout, arq_common.cc:1216-1260)
        if self.link_status == P.CONNECTED:
            if self._last_peer_activity is None:
                self._last_peer_activity = now
            if now - self._last_peer_activity > self.cfg.link_timeout_ms:
                if self.role == P.RESPONDER:
                    # back to listening at the initial config so a
                    # re-connecting commander can reach us
                    self.link_status = P.LISTENING
                    self._rx_msgs.clear()
                    self._rx_block_seq = -1
                    self._had_acked_block = False
                    self._last_ack_multi = None
                    self._set_config(self.cfg.init_configuration)
                    self.on_event("LINK TIMEOUT")
                else:
                    # reference behavior (arq_common.cc:1216-1260): the
                    # commander auto-reconnects at the initial configuration;
                    # un-ACKed data goes back to the TX FIFO
                    self._requeue_block()
                    self._await_ack_kind = None
                    self._pending_control = None
                    self._gear_pending = None
                    self._gear_request = None
                    self._post_break_target = None
                    self._turbo_active = False
                    self._turbo_stage = None
                    self._turbo_seeded = False
                    self._turbo_wait_until = None
                    self._tried_repeat = False
                    self.emergency_nacks = 0
                    self._resends_left = self.cfg.n_resends
                    self._set_config(self.cfg.init_configuration)
                    self.link_status = P.CONNECTING
                    self._resume_connect = True   # keep stream offsets
                    self._last_peer_activity = now
                    self.on_event("LINK TIMEOUT - RECONNECTING")
                return out

        if self.role != P.COMMANDER:
            return out

        # ack timeout handling
        if self._await_ack_kind is not None:
            if now < self._await_deadline:
                return out
            kind = self._await_ack_kind
            self._await_ack_kind = None
            if kind == "control" and self._turbo_stage is not None:
                # turbo probe failed: back to the rendezvous config
                self._pending_control = None
                self._set_config(self._turbo_rendezvous)
                if self._turbo_seeded and self._turbo_stage in ("set", "test"):
                    # the SNR-seeded jump overshot the channel: fall back to
                    # incremental one-step probing from the rendezvous, after
                    # waiting out the responder's probe-revert deadline so
                    # both ends are back at the rendezvous config
                    self._turbo_seeded = False
                    self._turbo_stage = None
                    self._turbo_candidate = self._ladder_up()
                    self._turbo_wait_until = now + 3 * self.frame_ms + 2500
                    if self._turbo_candidate == self._turbo_rendezvous:
                        self._turbo_active = False
                        self.on_event(f"TURBO DONE {self.current_configuration}")
                    else:
                        self.on_event(f"TURBO FALLBACK {self._turbo_candidate}")
                    return out
                self._turbo_active = False
                self._turbo_stage = None
                self.on_event(f"TURBO DONE {self.current_configuration}")
                return out
            if kind == "control" and self._gear_pending is not None:
                # gearshift proposal unACKed: drop it and stay on the old
                # config — do NOT resend (the responder may have switched and
                # will revert via its deadline; resending at the old config
                # while it listens on the new one would desync the link)
                self._pending_control = None
                self._gear_pending = None
                self._gear_recovering = False
                self.consecutive_data_acks = 0
                return out
            self._resends_left -= 1
            self.consecutive_data_acks = 0
            if kind == "data":
                if self._gear_just_applied:
                    # the very first block after an upshift got NO answer:
                    # the new config can't pass data. BREAK immediately (no
                    # REPEAT retry), double the shift threshold, and recover
                    # one ladder step below the failed config
                    # (reference: arq_commander.cc:1000-1045)
                    self._gear_just_applied = False
                    self.frame_shift_threshold *= 2
                    target = ladder_down(self.current_configuration, 1,
                                         self.cfg.robust_enabled)
                    self.on_event(
                        f"UPSHIFT FAILED threshold={self.frame_shift_threshold}")
                    return [self._emergency_break(now, target)]
                if not self._tried_repeat:
                    # maybe only the ACK was lost: ask the responder to
                    # repeat it before re-sending the whole block
                    # (reference REPEAT_LAST_ACK, datalink_defines.h:83)
                    self._tried_repeat = True
                    ctrl = P.Message(type=P.CONTROL, length=1,
                                     data=bytes([P.REPEAT_LAST_ACK]))
                    out.append(self._modulate_control(ctrl))
                    self._start_wait("data", now)
                    return out
                self._tried_repeat = False
                self.emergency_nacks += 1
                if (self.cfg.gear_shift_on
                        and self.emergency_nacks >= self.cfg.emergency_nack_threshold):
                    return [self._emergency_break(now)]
            if self._resends_left <= 0:
                self.link_status = P.DROPPED
                self.on_event("LINK FAILED")
                return out
            # fall through to retransmit below

        if self.link_status == P.CONNECTING and self._pending_control is None:
            data = bytes([P.START_CONNECTION,
                          P.crc8(self.destination_call_sign.encode())]) \
                + P.callsign_pack(self.call_sign)
            # the CONTROL header's (otherwise unused) sequence byte carries
            # the resume flag: 1 = link-timeout reconnect, keep stream
            # offsets; 0 = fresh session, responder resets its RX offset
            self._pending_control = P.Message(
                type=P.CONTROL, length=len(data), data=data,
                sequence=1 if self._resume_connect else 0)

        # post-BREAK recovery: both ends coordinated at the ladder floor —
        # jump straight to the recovery target instead of re-climbing
        # (reference BREAK ladder, arq_commander.cc:42-187)
        if (self.link_status == P.CONNECTED and self._post_break_target is not None
                and self._pending_control is None and self._gear_pending is None):
            target = self._post_break_target
            self._post_break_target = None
            if target != self.current_configuration:
                self._gear_request = target
                self._gear_recovering = True

        # turboshift probe driver
        if (self.link_status == P.CONNECTED and self._turbo_active
                and self._pending_control is None
                and (self._turbo_wait_until is None
                     or now >= self._turbo_wait_until)):
            self._turbo_wait_until = None
            if self._turbo_stage == "snr":
                self._pending_control = self._make_test_connection()
            elif self._turbo_stage is None:
                data = bytes([P.SET_CONFIG, self._turbo_candidate & 0xFF,
                              self._turbo_rendezvous & 0xFF, 1,
                              CONFIG_UNCHANGED])
                self._pending_control = P.Message(type=P.CONTROL,
                                                  length=len(data), data=data)
            elif self._turbo_stage == "test":
                self._pending_control = self._make_test_connection()

        if self._pending_control is not None:
            if (self._turbo_active and self._turbo_stage is None
                    and self._pending_control.data[0] == P.SET_CONFIG):
                self._turbo_stage = "set"
            out.append(self._modulate_control(self._pending_control))
            self._start_wait("control", now)
            return out

        if self.link_status != P.CONNECTED:
            return out

        # gearshift proposal: queued request (success-rate downshift or
        # post-BREAK recovery) first, then the frame-level upshift
        if self.cfg.gear_shift_on and self._gear_pending is None:
            nxt = None
            if self._gear_request is not None:
                nxt = self._gear_request
                self._gear_request = None
            elif self.consecutive_data_acks >= self.frame_shift_threshold:
                up = self._ladder_up()
                if up != self.current_configuration:
                    nxt = up
                else:
                    self.consecutive_data_acks = 0
            if nxt is not None and nxt != self.current_configuration:
                self._gear_pending = nxt
                # reverse config rides along when we know the peer's SNR
                # toward us (asymmetric negotiation, arq_commander.cc:319-341)
                rev = CONFIG_UNCHANGED
                if self.snr_local is not None:
                    rev = get_configuration(self.snr_local)
                if self.cfg.wire_compat:
                    # stock payload (arq_commander.cc:319-341):
                    # [code, forward, reverse] — no revert/flag bytes
                    rev_stock = (self.reverse_configuration
                                 if self.reverse_configuration is not None
                                 else nxt)
                    data = bytes([P.SET_CONFIG, nxt & 0xFF, rev_stock & 0xFF])
                else:
                    data = bytes([P.SET_CONFIG, nxt & 0xFF,
                                  self.current_configuration & 0xFF, 0, rev])
                self._pending_control = P.Message(type=P.CONTROL,
                                                  length=len(data), data=data)
                out.append(self._modulate_control(self._pending_control))
                self._start_wait("control", now)
                return out

        # idle keep-alive (reference KEEP_ALIVE, datalink_defines.h:75)
        if (self.link_status == P.CONNECTED and not self.fifo_tx
                and not self._block_msgs and self._pending_control is None
                and self._last_peer_activity is not None
                and now - self._last_peer_activity > self.cfg.link_timeout_ms / 3):
            self._pending_control = P.Message(type=P.CONTROL, length=1,
                                              data=bytes([P.KEEP_ALIVE]))
            out.append(self._modulate_control(self._pending_control))
            self._start_wait("control", now)
            return out

        # data block (fresh, full resend after repeat-ambiguity, or
        # selective resend of just the missing messages)
        if self._block_msgs or self.fifo_tx:
            if not self._block_msgs:
                self._assemble_block()
            to_send = [m for m in self._block_msgs if m.status != P.ACKED]
            if not to_send:
                # everything individually acked but completion never fired
                # (can't normally happen) — treat as complete
                self._complete_block(now)
                return out
            batch = list(to_send)
            count = len(self._block_msgs)
            if self.cfg.wire_compat:
                # stock framing: sequence = batch position
                # (arq_common.cc:2161); BLOCK_END goes out as its own
                # control message after the data ack (arq_commander.cc:1616)
                for i, m in enumerate(batch):
                    m.sequence = i
            else:
                # BLOCK_END carries the message count and the block's byte
                # offset in the TX stream so the responder can exactly
                # dedupe a retransmit of a block whose ACK was lost — even
                # across reconnects and config changes that reframe the
                # bytes (extension over the reference, which can deliver
                # duplicates in that scenario)
                batch.append(P.Message(
                    type=P.CONTROL, length=6, sequence=self._block_seq & 0xFF,
                    data=bytes([P.BLOCK_END, count])
                    + int(self._block_off).to_bytes(4, "little")))
            out.append(self._modulate_batch(batch))
            if self._block_sent_once:
                self.stats.resent_data += len(to_send)
                self._blk_resent += len(to_send)
            else:
                self.stats.sent_data += len(to_send)
                self._blk_sent = len(to_send)   # first-send count (reference
                self._block_sent_once = True    # nSent semantics)
            self.stats.blocks_sent += 1
            self._start_wait("data", now)
            return out

        return out

    def _make_test_connection(self) -> P.Message:
        snr = self.snr_local
        if snr is None and (self.signal_dbm is not None
                            and self.noise_floor_dbm is not None):
            # no decoded frame yet: fall back to the idle-channel estimate
            # (last window's signal over the idle noise floor) so turboshift
            # seeding on the other end gets evidence instead of -99.9
            snr = self.signal_dbm - self.noise_floor_dbm
        if snr is None:
            snr = -99.9
        data = bytes([P.TEST_CONNECTION]) + struct.pack("<f", float(snr))
        return P.Message(type=P.CONTROL, length=len(data), data=data)

    def _assemble_block(self) -> None:
        # stream offset of this block's first byte: fifo_tx[0] always sits at
        # _tx_off (ACKed bytes advance it; requeued bytes return to the front)
        self._block_off = self._tx_off
        self._block_seq = (self._block_seq + 1) & 0xFF
        self._block_msgs = []
        self._block_sent_once = False
        self._blk_sent = 0
        self._blk_resent = 0
        mid = 0
        while self.fifo_tx and mid < self.cfg.batch_size:
            chunk = bytes(self.fifo_tx[: self.max_data_length])
            del self.fifo_tx[: len(chunk)]
            mtype = P.DATA_LONG if len(chunk) == self.max_data_length else P.DATA_SHORT
            self._block_msgs.append(
                P.Message(type=mtype, id=mid, sequence=self._block_seq & 0xFF,
                          length=len(chunk), data=chunk))
            mid += 1

    def _ladder_up(self) -> int:
        return ladder_up(self.current_configuration, self.cfg.robust_enabled)

    def _emergency_break(self, now: float,
                         target: int | None = None) -> np.ndarray:
        """Send the BREAK pattern and drop to the ladder floor for
        coordination (reference: arq_commander.cc:42-187). The recovery
        target (previous config minus the progressive drop step — 1, 2, 4…
        steps for consecutive BREAKs) is then proposed via SET_CONFIG at the
        floor config instead of re-climbing the whole ladder."""
        prev = self.current_configuration
        if target is None:
            target = ladder_down(prev, self._break_step,
                                 self.cfg.robust_enabled)
            self._break_step = min(self._break_step * 2, 8)
        self.emergency_nacks = 0
        self.stats.breaks_sent += 1
        self.stats.gearshift_downs += 1
        pattern = self._pat.break_passband.astype(np.float32)
        self._set_config(self._ladder_floor())
        self._post_break_target = (target if target != self.current_configuration
                                   else None)
        self.on_event(f"BREAK -> {self.current_configuration}"
                      + (f" (recover {target})" if self._post_break_target
                         is not None else ""))
        return pattern

    def send_marker(self, code: int) -> None:
        """Queue a FILE_START/FILE_END/PIPE_OPEN/PIPE_CLOSE control marker."""
        assert code in (P.FILE_START, P.FILE_END_, P.PIPE_OPEN, P.PIPE_CLOSE)
        self._pending_control = P.Message(type=P.CONTROL, length=1,
                                          data=bytes([code]))

    def switch_role(self) -> None:
        """Hand the commander role to the peer (reference SWITCH_ROLE,
        datalink_defines.h:80) so it can transmit its queued data. Carries
        the negotiated reverse config so both ends switch to it atomically."""
        assert self.role == P.COMMANDER and self.link_status == P.CONNECTED
        rev = (self.reverse_configuration
               if self.reverse_configuration is not None else CONFIG_UNCHANGED)
        self._pending_control = P.Message(
            type=P.CONTROL, length=2, data=bytes([P.SWITCH_ROLE, rev & 0xFF]))

    def disconnect(self) -> list[np.ndarray]:
        data = bytes([P.CLOSE_CONNECTION])
        self._pending_control = P.Message(type=P.CONTROL, length=1, data=data)
        self.link_status = P.DISCONNECTING
        return []
