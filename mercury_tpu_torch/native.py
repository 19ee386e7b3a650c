"""Build and load the CUDA kernels of `csrc/`.

The sources are compiled by `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with `ctypes`. The build happens at
first use, into `build/mercury_tpu_torch/` at the repository root, under a
name keyed by a hash of the sources, so an edited source rebuilds and an
unchanged one loads the library already built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "mercury_tpu_torch"
SOURCES = ("mix_fir_decimate.cu", "deep_mf_score.cu")
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (name, argument types); every entry returns cudaError_t
_SIGNATURES = {
    # pb, osc, taps, start, out, batch, n, n_out, stride, offset, ntaps, stream
    "mfd_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # seg, tmpl, ce, ef, out, batch, num_a, seg_len, lp, s, n_cand, stream
    "dmf_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def source_paths() -> list[pathlib.Path]:
    return [CSRC / name for name in SOURCES]


def source_hash() -> str:
    h = hashlib.sha256()
    for path in source_paths():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(nvcc) if nvcc.exists() else (shutil.which("nvcc") or "nvcc")


def build_command(out: pathlib.Path) -> list[str]:
    """The nvcc command line that builds the kernel library at `out`."""
    return [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out),
            *[str(p) for p in source_paths()]]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libmercury_kernels_{source_hash()}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(build_command(pathlib.Path(tmp)),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
