"""Package boundary of mercury_tpu_torch: it imports neither JAX (the GPU
machine has none) nor the JAX package `mercury_tpu`, its entry points run on
the card unless the caller asks for the CPU, and its kernel build reads only
its own CUDA sources and targets Hopper (sm_90a)."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from mercury_tpu_torch import native
from mercury_tpu_torch.convert import resolve_device, rx_state_from_numpy
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.link import protocol as P
from mercury_tpu_torch.link.node import ArqNode
from mercury_tpu_torch.link.tcp_api import ArqTcpServer
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import serve

REPO = pathlib.Path(__file__).resolve().parent.parent
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (REPO / "mercury_tpu_torch").rglob("*.py"))
# the files that must run on a machine with neither JAX nor mercury_tpu
JAX_FREE = sorted(
    [str(p.relative_to(REPO))
     for p in (REPO / "mercury_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "tests/test_torch_cuda.py"])


def _imported(path: pathlib.Path) -> list[str]:
    """Every module name an import statement of the file names."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


@pytest.mark.parametrize("rel", JAX_FREE)
def test_imports_neither_jax_nor_mercury_tpu(rel):
    bad = [n for n in _imported(REPO / rel)
           if n.split(".")[0] in ("jax", "jaxlib", "mercury_tpu")]
    assert not bad, f"{rel} imports {bad}"


def test_imports_and_receives_without_jax():
    """Every port module imports, and a CPU transmit and receive run, with
    neither jax nor any mercury_tpu module loaded."""
    code = ("import importlib, sys\n"
            "import numpy as np, torch\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from mercury_tpu_torch.core.geometry import build_geometry\n"
            "from mercury_tpu_torch.modem.rx import RxChain\n"
            "from mercury_tpu_torch.modem.tx import TxChain\n"
            "g = build_geometry(9)\n"
            "payload = torch.arange(g.frame_bytes, dtype=torch.uint8)[None]\n"
            "frame = TxChain(g, device='cpu').transmit(payload)\n"
            "buf = torch.zeros((1, g.nofdm * g.buffer_nsymb * g.interp))\n"
            "d = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp\n"
            "buf[:, d: d + frame.shape[1]] = frame\n"
            "res = RxChain(g, device='cpu').receive(buf)\n"
            "assert bool(res.crc_ok[0]) and torch.equal(res.payload, payload)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'mercury_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("make", [
    lambda g: RxChain(g), lambda g: TxChain(g),
    lambda g: rx_state_from_numpy({}), lambda g: resolve_device(),
    lambda g: ArqNode("N0CALL", P.RESPONDER),
    lambda g: ArqTcpServer(base_port=17702),
    lambda g: serve.StreamPool(g, 2), lambda g: serve.DeviceStreamPool(g, 2),
    lambda g: serve.FusedDevicePool(g, 2)],
    ids=["RxChain", "TxChain", "rx_state_from_numpy", "resolve_device",
         "ArqNode", "ArqTcpServer", "StreamPool", "DeviceStreamPool",
         "FusedDevicePool"])
def test_no_device_without_gpu_raises(make):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(build_geometry(9, with_pre_eq=False))


@pytest.mark.cuda
def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = build_geometry(9, with_pre_eq=False)
    assert RxChain(g).device.type == TxChain(g).gen.device.type == "cuda"


def test_cpu_device_keeps_every_buffer_on_the_cpu():
    g = build_geometry(9, with_pre_eq=False)
    for chain in (RxChain(g, device="cpu"), TxChain(g, device="cpu")):
        tensors = list(chain.buffers())
        assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_build_command_targets_sm90a_and_reads_only_csrc(tmp_path):
    out = tmp_path / "lib.so"
    compiles, link = native.build_commands(out, tmp_path)
    for cmd in (*compiles, link):
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    # one nvcc per source, each writing its object into the build directory
    inputs, objs = [], []
    for cmd in compiles:
        srcs = [pathlib.Path(a) for a in cmd
                if a.endswith((".cu", ".cuh", ".cpp"))]
        assert len(srcs) == 1
        inputs += srcs
        objs.append(cmd[cmd.index("-o") + 1])
        assert pathlib.Path(objs[-1]).parent == tmp_path
    csrc = (REPO / "mercury_tpu_torch" / "csrc").resolve()
    assert sorted(p.name for p in inputs) == sorted(
        p.name for p in csrc.glob("*.cu"))
    assert all(p.resolve().parent == csrc for p in inputs)
    assert link[link.index("-o") + 1] == str(out)
    assert link[-len(objs):] == objs
    # the library name follows the sources' hash, under build/
    lib = native.library_path()
    assert lib.parent == REPO / "build" / "mercury_tpu_torch"
    assert native.source_hash() in lib.name
