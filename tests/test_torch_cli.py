"""`python -m mercury_tpu_torch` against the JAX package's CLI, on the CPU:
the mode table, a TX_TEST frame file (equal to the JAX CLI's to 1e-5) that
RX_TEST decodes back to its payload, the --write-ini output, a short
two-node SIM, and the device rule: without --cpu and without a card a mode
that builds a chain exits non-zero with convert.resolve_device's message."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mercury_tpu import __main__ as jcli
from mercury_tpu_torch import __main__ as cli

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def no_ini(tmp_path, monkeypatch):
    """Run from an empty directory with an empty HOME, so no INI file is
    found and the compiled defaults apply."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


def test_list_mode_runs_as_a_module(capsys):
    proc = subprocess.run(
        [sys.executable, "-m", "mercury_tpu_torch", "-m", "LIST", "--cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert jcli.main(["-m", "LIST", "--cpu"]) == 0
    assert proc.stdout == capsys.readouterr().out
    assert len(proc.stdout.splitlines()) == 21       # header + 20 modes


def test_tx_test_matches_jax_and_rx_test_decodes(no_ini, capsysbinary):
    data = bytes(np.random.default_rng(4).integers(0, 256, 30)
                 .astype(np.uint8))
    (no_ini / "payload.bin").write_bytes(data)
    for main, out in ((cli.main, "port.f32"), (jcli.main, "jax.f32")):
        assert main(["-m", "TX_TEST", "-s", "9", "-i", "payload.bin",
                     "-o", out, "--cpu"]) == 0
    ours = np.fromfile(no_ini / "port.f32", np.float32)
    theirs = np.fromfile(no_ini / "jax.f32", np.float32)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    capsysbinary.readouterr()
    assert cli.main(["-m", "RX_TEST", "-s", "9", "-i", "port.f32",
                     "--cpu"]) == 0
    out = capsysbinary.readouterr().out
    text, _, frame = out.partition(b"\n")
    assert text.startswith(b"decoded=True")
    assert frame == data.ljust(len(frame), b"\0") and len(frame) > len(data)


def test_write_ini_matches_jax(no_ini):
    flags = ["-s", "3", "-p", "8100", "-g", "0", "--turbo", "-r", "sbitx",
             "--rx-profile", "track", "--wire-compat"]
    assert cli.main(flags + ["--write-ini", "port.ini"]) == 0
    assert jcli.main(flags + ["--write-ini", "jax.ini"]) == 0
    assert ((no_ini / "port.ini").read_text()
            == (no_ini / "jax.ini").read_text())


def test_sim_mode_completes(no_ini, capsys):
    assert cli.main(["-m", "SIM", "--cpu", "-s", "0", "-g", "0",
                     "--bytes", "40", "--snr", "20"]) == 0
    assert "40/40 bytes (OK)" in capsys.readouterr().out


def test_no_card_without_cpu_flag_exits_nonzero(no_ini, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    assert cli.main(["-m", "SIM", "--bytes", "10"]) != 0
    assert "device='cpu'" in capsys.readouterr().err
