"""The port's VARA-compatible TCP service (`mercury_tpu_torch.link.tcp_api`)
on the CPU: tests/test_tcp_api.py's end-to-end scenario (two servers in one
process over the in-process pair transport, driven through raw sockets; the
two drive threads share the cached PHY chains) and its runtime control
commands. Ports 17402-17403, 17412-17413 and 17602-17603 are this file's:
no other test file binds them (tests/test_tcp_api.py holds 17002-17003,
17012-17013 and 17202-17203)."""

import socket
import time

import pytest
import torch

from mercury_tpu_torch.link.node import ArqConfig
from mercury_tpu_torch.link.tcp_api import ArqTcpServer
from mercury_tpu_torch.link.transport import PairTransport


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _recv_lines(sock, timeout=5.0):
    sock.settimeout(timeout)
    buf = b""
    try:
        while b"\r" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                break
            buf += chunk
    except socket.timeout:
        pass
    return [ln.decode() for ln in buf.split(b"\r") if ln]


def test_tcp_api_end_to_end():
    pair = PairTransport()
    cfg = ArqConfig(init_configuration=0, gear_shift_on=False, batch_size=2)
    srv_a = ArqTcpServer(base_port=17402, config=cfg, transport=pair.a,
                         device="cpu")
    srv_b = ArqTcpServer(base_port=17412, config=cfg, transport=pair.b,
                         device="cpu")
    assert srv_a.node._rx is srv_b.node._rx      # one shared chain
    srv_a.start()
    srv_b.start()
    time.sleep(0.5)

    ctl_a = socket.create_connection(("127.0.0.1", 17402))
    dat_a = socket.create_connection(("127.0.0.1", 17403))
    ctl_b = socket.create_connection(("127.0.0.1", 17412))
    dat_b = socket.create_connection(("127.0.0.1", 17413))
    try:
        ctl_b.sendall(b"MYCALL N0CALL\r")
        assert "OK" in _recv_lines(ctl_b)
        ctl_b.sendall(b"LISTEN ON\r")
        assert "OK" in _recv_lines(ctl_b)

        ctl_a.sendall(b"CONNECT VE3XYZ N0CALL\r")
        lines = []
        deadline = time.time() + 5
        while time.time() < deadline and "PENDING" not in lines:
            lines += _recv_lines(ctl_a, 1.0)
        assert "OK" in lines and "PENDING" in lines

        deadline = time.time() + 120
        a_conn = b_conn = False
        while time.time() < deadline and not (a_conn and b_conn):
            a_conn = a_conn or any("CONNECTED" in ln
                                   for ln in _recv_lines(ctl_a, 1.0))
            b_conn = b_conn or any("CONNECTED" in ln
                                   for ln in _recv_lines(ctl_b, 1.0))
        assert a_conn and b_conn, "no CONNECTED event on control sockets"

        payload = b"TCP API ROUNDTRIP " * 3
        dat_a.sendall(payload)
        got = b""
        dat_b.settimeout(2.0)
        deadline = time.time() + 150
        while time.time() < deadline and len(got) < len(payload):
            try:
                chunk = dat_b.recv(8192)
                if chunk:
                    got += chunk
            except socket.timeout:
                pass
        assert got[: len(payload)] == payload

        ctl_a.sendall(b"BUFFER TX\r")
        assert any(ln.startswith("BUFFER") for ln in _recv_lines(ctl_a))
    finally:
        for s in (ctl_a, dat_a, ctl_b, dat_b):
            s.close()
        srv_a.stop()
        srv_b.stop()
        for t in srv_a._threads + srv_b._threads:
            t.join(5.0)
    assert not any(t.is_alive() for t in srv_a._threads + srv_b._threads)


def test_shared_caches_fill_once_across_threads():
    """Nodes in several threads share one process-wide chain cache and the
    chains' own caches: 16 threads asking at once, with a short switch
    interval, all get the same chain and the same oscillator table (a fill
    that two threads raced would hand out two)."""
    import sys
    import threading

    from mercury_tpu_torch.link.node import _PhyCache

    n_threads, n = 16, 4099                # a length no receive uses
    got, errors = [], []
    start = threading.Barrier(n_threads)

    def worker():
        try:
            start.wait(timeout=10)
            g, tx, rx, pat = _PhyCache.get(16, "static", 0.0, 37, "cpu")
            got.append((rx, rx._osc_const(n), pat._osc(n)))
        except Exception as e:            # reported below, with the rest
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == n_threads
    for i in range(3):
        assert len({id(x[i]) for x in got}) == 1


def test_runtime_control_commands():
    """tests/test_tcp_api.py::test_runtime_control_commands on the port
    (the server is not started: commands go straight to the handler)."""
    pair = PairTransport()
    cfg = ArqConfig(init_configuration=0, gear_shift_on=True, batch_size=2)
    srv = ArqTcpServer(base_port=17602, config=cfg, transport=pair.a,
                       device="cpu")
    replies = []
    srv._reply = replies.append
    rx = srv.node._rx
    try:
        srv._handle_command("STATUS")
        assert replies[-1].startswith("STATUS link=")
        assert "load=" in replies[-1] and "buftx=" in replies[-1]

        srv._handle_command("LDPCITER 25")
        assert replies[-1] == "OK"
        assert rx.ldpc_max_iter == 25 and rx.decoder.max_iter == 25
        srv._handle_command("LDPCITER 9999")
        assert replies[-1] == "WRONG"

        srv._handle_command("TXGAIN -6")
        assert replies[-1] == "OK"
        assert srv.transport.tx_gain == pytest.approx(10 ** (-6 / 20))
        srv._handle_command("RXGAIN 3")
        assert replies[-1] == "OK"
        assert srv.transport.rx_gain == pytest.approx(10 ** (3 / 20))

        srv._handle_command("GEARSHIFT OFF")
        assert replies[-1] == "OK" and srv.node.cfg.gear_shift_on is False
        srv._handle_command("GEARSHIFT ON")
        assert srv.node.cfg.gear_shift_on is True

        srv._handle_command("SETCONFIG 3")
        assert replies[-1] == "OK"
        assert srv.node.current_configuration == 3

        srv._handle_command("SIGNAL")
        assert replies[-1].startswith("SIGNAL ")
    finally:
        # the chain is the process's shared CONFIG_0 chain
        rx.set_ldpc_max_iter(50)
