"""Package boundary of mercury_tpu_torch: it imports without JAX (the GPU
machine has none), and its kernel build reads only its own CUDA sources and
targets Hopper (sm_90a)."""

import pathlib
import subprocess
import sys

from mercury_tpu_torch import native

REPO = pathlib.Path(__file__).resolve().parent.parent
MODULES = [
    "mercury_tpu_torch", "mercury_tpu_torch.native",
    "mercury_tpu_torch.convert", "mercury_tpu_torch.dsp.ops",
    "mercury_tpu_torch.dsp.kernels", "mercury_tpu_torch.fec.ldpc",
    "mercury_tpu_torch.modem.psk", "mercury_tpu_torch.modem.tx",
    "mercury_tpu_torch.modem.sync", "mercury_tpu_torch.modem.rx",
    "mercury_tpu_torch.channel.sim",
]


def test_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from mercury_tpu.core.geometry import build_geometry\n"
            "from mercury_tpu_torch.modem.rx import RxChain\n"
            "RxChain(build_geometry(9))\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


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
