"""Sample transports: how ARQ nodes reach the air.

The reference couples its ARQ to sound-card threads (source/audioio); here a
transport is a tiny interface — transmit(samples) / capture() — with
implementations for in-process loopback pairs (testing two TCP servers
against each other) and UDP sample streaming between processes/machines.
"""

from __future__ import annotations

import queue
import socket
import struct

import numpy as np


class PairTransport:
    """In-process pair: what one end transmits, the other captures
    (optionally through a channel model)."""

    def __init__(self, channel=None):
        self.channel = channel
        self._a_to_b: queue.Queue = queue.Queue()
        self._b_to_a: queue.Queue = queue.Queue()
        self.a = _PairEnd(self._a_to_b, self._b_to_a, channel)
        self.b = _PairEnd(self._b_to_a, self._a_to_b, channel)


class _PairEnd:
    def __init__(self, tx_q, rx_q, channel):
        self._tx_q, self._rx_q, self._channel = tx_q, rx_q, channel
        # runtime-settable linear gains (reference audioio TX/RX gain,
        # audioio.c:423/738; set via the TCP API TXGAIN/RXGAIN commands)
        self.tx_gain = 1.0
        self.rx_gain = 1.0

    def transmit(self, samples: np.ndarray) -> None:
        out = np.asarray(samples, dtype=np.float32) * self.tx_gain
        if self._channel is not None:
            out = self._channel.apply(out)
        self._tx_q.put(out)

    def capture(self) -> np.ndarray | None:
        blocks = []
        try:
            while True:
                blocks.append(self._rx_q.get_nowait())
        except queue.Empty:
            pass
        if not blocks:
            return None
        return np.concatenate(blocks) * self.rx_gain


class UdpTransport:
    """Streams float32 passband blocks over UDP (e.g. to a soundcard bridge
    or another modem instance). Frame: uint32 length + float32 samples."""

    MAX_CHUNK = 8192

    def __init__(self, local_port: int, remote_host: str, remote_port: int):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("0.0.0.0", local_port))
        self._sock.setblocking(False)
        self._remote = (remote_host, remote_port)
        self._rx_parts: dict[int, list] = {}
        self._next_id = 0

    def transmit(self, samples: np.ndarray) -> None:
        data = np.asarray(samples, dtype=np.float32).tobytes()
        bid = self._next_id & 0xFFFF
        self._next_id += 1
        n_chunks = (len(data) + self.MAX_CHUNK - 1) // self.MAX_CHUNK
        for i in range(n_chunks):
            chunk = data[i * self.MAX_CHUNK: (i + 1) * self.MAX_CHUNK]
            hdr = struct.pack(">HHH", bid, i, n_chunks)
            self._sock.sendto(hdr + chunk, self._remote)

    MAX_PENDING = 64   # cap reassembly entries (lost chunks would otherwise
                       # leak, and a wrapped 16-bit bid could merge chunks of
                       # two different blocks into one corrupted capture)

    def capture(self) -> np.ndarray | None:
        done = []
        while True:
            try:
                pkt, _ = self._sock.recvfrom(65536)
            except BlockingIOError:
                break
            bid, i, n = struct.unpack(">HHH", pkt[:6])
            parts = self._rx_parts.get(bid)
            if parts is None or len(parts) != n:
                # new block (or stale entry from a wrapped bid): start fresh
                if len(self._rx_parts) >= self.MAX_PENDING:
                    self._rx_parts.pop(next(iter(self._rx_parts)))
                parts = self._rx_parts[bid] = [None] * n
            if i < len(parts):
                parts[i] = pkt[6:]
            if all(p is not None for p in parts):
                done.append(b"".join(parts))
                del self._rx_parts[bid]
        if not done:
            return None
        return np.concatenate([np.frombuffer(d, np.float32) for d in done])
