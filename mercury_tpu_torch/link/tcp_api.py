"""VARA-compatible TCP service: control + data ports around an ArqNode.

Mirrors the reference's TCP text API (process_user_command,
arq_common.cc:1742-1922; documented INTERNALS:33-84): control port (default
7002) accepts `MYCALL`, `LISTEN ON/OFF`, `CONNECT <from> <to>`, `DISCONNECT`,
`ABORT`, `BW2300/BW2500`, `BUFFER TX` and emits `OK`, `PENDING`,
`CONNECTED <a> <b> <bw>`, `DISCONNECTED`, `PTT ON/OFF`, `BUFFER n` events;
the data port (control+1, default 7003) streams payload bytes both ways.

The server owns the ArqNode and drives it from a background thread; sample
I/O goes through a pluggable transport (the link.sim harness in tests, a
sound-card/socket transport in deployment).
"""

from __future__ import annotations

import socket
import threading
import time

from mercury_tpu_torch.link import protocol as P
from mercury_tpu_torch.link.node import ArqConfig, ArqNode


class ArqTcpServer:
    def __init__(self, host: str = "127.0.0.1", base_port: int = 7002,
                 config: ArqConfig | None = None, transport=None,
                 device=None):
        self.host, self.base_port = host, base_port
        self.cfg = config or ArqConfig()
        self.transport = transport
        self.node = ArqNode("NOCALL", P.RESPONDER, self.cfg,
                            on_event=self._on_node_event, device=device)
        self._ctl_conn = None
        self._data_conn = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def start(self) -> None:
        for port, handler in ((self.base_port, self._serve_control),
                              (self.base_port + 1, self._serve_data)):
            t = threading.Thread(target=self._listen, args=(port, handler),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._drive, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------------
    def _listen(self, port: int, handler) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, port))
        srv.listen(2)
        srv.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            handler(conn)
        srv.close()

    def _serve_control(self, conn: socket.socket) -> None:
        self._ctl_conn = conn
        buf = b""
        conn.settimeout(0.5)
        while not self._stop.is_set():
            try:
                chunk = conn.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while b"\r" in buf:
                line, buf = buf.split(b"\r", 1)
                self._handle_command(line.decode(errors="replace").strip())
        if self._ctl_conn is conn:
            self._ctl_conn = None

    def _serve_data(self, conn: socket.socket) -> None:
        self._data_conn = conn
        conn.settimeout(0.2)
        while not self._stop.is_set():
            try:
                chunk = conn.recv(8192)
            except socket.timeout:
                chunk = None
            except OSError:
                break
            if chunk == b"":
                break
            if chunk:
                with self._lock:
                    self.node.send_data(chunk)
            # push received payload out (under the lock: the drive thread
            # appends to fifo_rx concurrently)
            with self._lock:
                out = self.node.received()
            if out:
                try:
                    conn.sendall(out)
                except OSError:
                    break
        if self._data_conn is conn:
            self._data_conn = None

    # ------------------------------------------------------------------
    def _reply(self, text: str) -> None:
        if self._ctl_conn is not None:
            try:
                self._ctl_conn.sendall((text + "\r").encode())
            except OSError:
                pass

    def _on_node_event(self, event: str) -> None:
        if event.startswith("CONNECTED"):
            other = event.split(" ", 1)[1] if " " in event else ""
            self._reply(f"CONNECTED {self.node.call_sign} {other} "
                        f"{int(self.node.geom.bandwidth)}")
        elif event.startswith("DISCONNECTED"):
            self._reply("DISCONNECTED")
        elif event.startswith("PTT"):
            self._reply(event)

    def _handle_command(self, command: str) -> None:
        """Reference-compatible command set (arq_common.cc:1742-1922)."""
        node = self.node
        if command.startswith("MYCALL "):
            node.call_sign = command[7:].strip().upper()
            self._reply("OK")
        elif command.startswith("CONNECT "):
            parts = command[8:].split()
            if len(parts) >= 2:
                node.call_sign = parts[0].upper()
                node.role = P.COMMANDER
                node.connect(parts[1])
                self._reply("OK")
                self._reply("PENDING")
            else:
                self._reply("WRONG")
        elif command == "DISCONNECT":
            node.disconnect()
            self._reply("OK")
        elif command == "ABORT":
            node.link_status = P.LISTENING
            node.role = P.RESPONDER
            node.fifo_tx.clear()
            self._reply("CANCELPENDING")
            self._reply("DISCONNECTED")
            self._reply("OK")
        elif command == "LISTEN ON":
            node.role = P.RESPONDER
            node.link_status = P.LISTENING
            self._reply("OK")
        elif command == "LISTEN OFF":
            node.role = P.RESPONDER
            node.link_status = P.IDLE
            self._reply("OK")
        elif command in ("BW2300", "BW2500"):
            self._reply("OK")   # fixed 2343.75 Hz numerology (reference parity)
        elif command == "BUFFER TX":
            self._reply(f"BUFFER {len(node.fifo_tx)}")
        elif command == "STATUS":
            # processing-load and buffer fill reported upward, like the
            # reference's gui_state feeds (gui_state.h:118-119)
            load = (f"{node.processing_load:.2f}"
                    if node.processing_load is not None else "NONE")
            self._reply(
                f"STATUS link={node.link_status} "
                f"cfg={node.current_configuration} "
                f"buftx={len(node.fifo_tx)} bufrx={len(node.fifo_rx)} "
                f"load={load} "
                f"snr={node.snr_local if node.snr_local is not None else 'NONE'} "
                f"dbm={node.signal_dbm if node.signal_dbm is not None else 'NONE'}")
        elif command.startswith("LDPCITER "):
            # runtime LDPC-iteration cap (reference GUI slider / -I flag);
            # triggers a receive-chain recompile like the reference's
            # subsystem reinit
            try:
                n = int(command[9:].strip())
                assert 1 <= n <= 200
            except (ValueError, AssertionError):
                self._reply("WRONG")
            else:
                node._rx.set_ldpc_max_iter(n)
                self._reply("OK")
        elif command.startswith("TXGAIN ") or command.startswith("RXGAIN "):
            # runtime audio gain (reference GUI sliders -> audioio gains,
            # audioio.c:423/738); acts on the attached transport
            try:
                db = float(command[7:].strip())
            except ValueError:
                self._reply("WRONG")
            else:
                attr = "tx_gain" if command.startswith("TX") else "rx_gain"
                if self.transport is not None and hasattr(self.transport, attr):
                    setattr(self.transport, attr, 10 ** (db / 20.0))
                    self._reply("OK")
                else:
                    self._reply("WRONG")
        elif command in ("TUNE ON", "TUNE OFF"):
            # antenna-tuning tone (reference GUI tune button ->
            # audioio.c:589-594); acts on an audio-backed transport
            if self.transport is not None and hasattr(self.transport,
                                                      "set_tune"):
                self.transport.set_tune(command.endswith("ON"))
                self._reply("OK")
            else:
                self._reply("WRONG")
        elif command in ("GEARSHIFT ON", "GEARSHIFT OFF"):
            import dataclasses as _dc
            node.cfg = _dc.replace(node.cfg,
                                   gear_shift_on=command.endswith("ON"))
            self._reply("OK")
        elif command.startswith("SETCONFIG "):
            # operator-forced config change: negotiated via SET_CONFIG on a
            # connected commander (reference setup dialog's mode change)
            try:
                c = int(command[10:].strip())
            except ValueError:
                self._reply("WRONG")
            else:
                if (node.role == P.COMMANDER
                        and node.link_status == P.CONNECTED):
                    node._gear_request = c
                    self._reply("OK")
                elif node.link_status in (P.IDLE, P.LISTENING):
                    node._set_config(c)
                    self._reply("OK")
                else:
                    self._reply("WRONG")
        elif command == "SIGNAL":
            # idle-channel measurement readout (reference surfaces
            # signal_stregth_dbm to its GUI/API, arq_common.cc:1714-1736):
            # last window dBm, idle noise floor dBm, decoded-frame SNR dB
            def _f(v):
                return f"{v:.1f}" if v is not None else "NONE"
            self._reply(f"SIGNAL {_f(node.signal_dbm)} "
                        f"{_f(node.noise_floor_dbm)} {_f(node.snr_local)}")
        else:
            self._reply("OK")

    # ------------------------------------------------------------------
    def _drive(self) -> None:
        """Pump the node against the transport (when one is attached)."""
        while not self._stop.is_set():
            now = time.monotonic() * 1000.0
            if self.transport is not None:
                with self._lock:
                    for block in self.node.poll(now):
                        self.transport.transmit(block)
                    rx = self.transport.capture()
                    if rx is not None:
                        self.node.on_samples(rx, now)
            time.sleep(0.05)
