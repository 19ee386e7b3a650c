"""ARQ wire protocol: message types, headers, callsign packing, CRC8.

Byte-compatible with the reference's data-link layer
(include/datalink_layer/datalink_defines.h, arq.h:45-86, serialization in
arq_common.cc:2025-2102/2157-2232).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

# Message status (datalink_defines.h:27-35)
FAILED_, ACK_TIMED_OUT, FREE, ADDED_TO_LIST, ADDED_TO_BATCH_BUFFER, \
    PENDING_ACK, ACKED, RECEIVED = -2, -1, 0, 1, 2, 3, 4, 5

# Link status (datalink_defines.h:37-46)
DROPPED, IDLE, CONNECTING, CONNECTED, DISCONNECTING, LISTENING, \
    CONNECTION_RECEIVED, CONNECTION_ACCEPTED, NEGOTIATING = \
    -1, 0, 1, 2, 3, 4, 5, 6, 7

# Connection status (datalink_defines.h:48-56)
TRANSMITTING_DATA, RECEIVING, RECEIVING_ACKS_DATA, ACKNOWLEDGING_DATA, \
    TRANSMITTING_CONTROL, RECEIVING_ACKS_CONTROL, ACKNOWLEDGING_CONTROL = \
    1, 2, 3, 4, 5, 6, 7

BROADCAST_ID = 0x00

# Message types (datalink_defines.h:61-69)
MSG_NONE = 0x00
DATA_LONG = 0x10
DATA_SHORT = 0x11
ACK_CONTROL = 0x20
ACK_RANGE = 0x21
ACK_MULTI = 0x22
CONTROL = 0x30

# Control commands (datalink_defines.h:71-83)
START_CONNECTION = 0x31
TEST_CONNECTION = 0x32
CLOSE_CONNECTION = 0x33
KEEP_ALIVE = 0x34
FILE_START = 0x35
FILE_END_ = 0x36
PIPE_OPEN = 0x37
PIPE_CLOSE = 0x38
SWITCH_ROLE = 0x39
BLOCK_END = 0x3A
SET_CONFIG = 0x3B
REPEAT_LAST_ACK = 0x3C

COMMANDER, RESPONDER = 0, 1

# Header lengths (datalink_defines.h:103-107)
HEADER_LEN = {DATA_LONG: 4, DATA_SHORT: 5, ACK_RANGE: 3, ACK_MULTI: 3,
              CONTROL: 3, ACK_CONTROL: 3}
MAX_HEADER_LEN = 5

POLY_CRC8 = 0xF4


def crc8(data: bytes) -> int:
    """CRC8 for callsign verification (reference: arq_common.cc:3202-3221,
    poly 0xF4 applied LSB-first with init 0xFF)."""
    crc = 0xFF
    for b in data:
        crc ^= b
        for _ in range(8):
            if crc & 0x01:
                crc = (crc >> 1) ^ POLY_CRC8
            else:
                crc >>= 1
    return crc & 0xFF


def callsign_pack(callsign: str) -> bytes:
    """Base-36 6-char callsign in 5 bytes (reference: arq.h:45-66)."""
    cs = callsign[:6]
    packed = (len(cs) & 0xF) << 36
    for i in range(6):
        val = 0
        if i < len(cs):
            c = cs[i]
            if "A" <= c <= "Z":
                val = ord(c) - ord("A")
            elif "a" <= c <= "z":
                val = ord(c) - ord("a")
            elif "0" <= c <= "9":
                val = ord(c) - ord("0") + 26
        packed |= (val & 0x3F) << (30 - i * 6)
    return bytes((packed >> s) & 0xFF for s in (32, 24, 16, 8, 0))


def callsign_unpack(data: bytes) -> str:
    packed = 0
    for b in data[:5]:
        packed = (packed << 8) | b
    length = min((packed >> 36) & 0xF, 6)
    out = []
    for i in range(length):
        val = (packed >> (30 - i * 6)) & 0x3F
        if val < 26:
            out.append(chr(ord("A") + val))
        elif val < 36:
            out.append(chr(ord("0") + val - 26))
    return "".join(out)


@dataclass
class Message:
    """One ARQ message (reference st_message, arq.h:100-111)."""
    type: int = MSG_NONE
    id: int = 0
    sequence: int = 0
    length: int = 0
    data: bytes = b""
    status: int = FREE
    n_resends: int = 0
    ack_timer_start: float | None = None   # simulated/wall ms


def serialize(msg: Message, connection_id: int) -> bytes:
    """Message -> frame bytes (header + payload), reference send() layout."""
    t = msg.type
    if t == DATA_LONG:
        hdr = bytes([t, connection_id, msg.sequence & 0xFF, msg.id & 0xFF])
    elif t == DATA_SHORT:
        hdr = bytes([t, connection_id, msg.sequence & 0xFF, msg.id & 0xFF,
                     msg.length & 0xFF])
    elif t in (ACK_RANGE, ACK_MULTI, CONTROL, ACK_CONTROL):
        hdr = bytes([t, connection_id, msg.sequence & 0xFF])
    else:
        raise ValueError(f"unknown message type {t}")
    return hdr + msg.data[: msg.length]


def deserialize(frame: bytes, max_data_length: int) -> Message | None:
    """Frame bytes -> Message (reference receive() header dispatch,
    arq_common.cc:2751-2813). Returns None for unknown types."""
    if not frame:
        return None
    t = frame[0]
    if t == DATA_LONG:
        return Message(type=t, sequence=frame[2], id=frame[3],
                       length=max_data_length, data=frame[4:4 + max_data_length])
    if t == DATA_SHORT:
        ln = frame[4]
        return Message(type=t, sequence=frame[2], id=frame[3], length=ln,
                       data=frame[5:5 + ln])
    if t in (ACK_RANGE, ACK_MULTI, CONTROL, ACK_CONTROL):
        return Message(type=t, sequence=frame[2],
                       length=len(frame) - 3, data=frame[3:])
    return None
