"""Build and load the CUDA kernels of `csrc/`.

Entry points (each returns a cudaError_t; the wrappers in `dsp/kernels.py`
call them): `mfd_launch` (mix_fir_decimate), `dmf_launch`,
`dmf_max_launch` and `dmf_best_launch` (deep_mf_score, deep_mf_max,
deep_mf_best; `dmf_best_rows` gives the rows from which the last pays),
`pcs_launch` (pilot_cand_score) and `ldpc_launch` (ldpc_layered).

Each source is compiled by its own `nvcc` for Hopper (`sm_90a`), all at
once, and the objects are linked into one shared library with a plain C
interface, loaded with `ctypes`. The build happens at first use, into
`build/mercury_tpu_torch/` at the repository root, under a name keyed by a
hash of the sources, so an edited source rebuilds and an unchanged one
loads the library already built.
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
SOURCES = ("mix_fir_decimate.cu", "deep_mf_score.cu", "pilot_cand_score.cu",
           "ldpc_layered.cu")
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (name, argument types); each returns an int
_SIGNATURES = {
    # pb, osc, taps, start (or NULL: every row at 0), freq (float32 Hz, or
    # NULL: no per-row offset), fs, out, batch, n, n_out, stride, offset,
    # ntaps, stream
    "mfd_launch": (_P, _P, _P, _P, _P, ctypes.c_double, _P, _I, _I, _I, _I,
                   _I, _I, _P),
    # seg, tmpl, ce, ef, out, batch, num_a, seg_len, lp, s, n_cand, n_cols,
    # stream
    "dmf_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # seg, tmpl, ce, ef, smax, sarg, batch, num_a, seg_len, lp, s, n_cand,
    # n_cols, stream
    "dmf_max_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P),
    # seg, tmpl, ce, ef, score, lag, batch, num_a, seg_len, lp, s, n_cand,
    # stream
    "dmf_best_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # num_a, lp, s, n_cand (a count of rows, not a cudaError_t)
    "dmf_best_rows": (_I, _I, _I, _I),
    # bb, idx0, fidx, bank_t, et, out, batch, n_dec, row_stride, step, m, f_n,
    # nsym, s, stream
    "pcs_launch": (_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _I,
                   _I, _I, _I, _P),
    # llr, lane_check, lane_var, var_ptr, var_id, var_edge_ptr, var_edge,
    # bits, iters, ok, post (or NULL), batch, n, n_layers, n_edges,
    # layer_slots, layer_scratch, group, slots_lane, checks_lane,
    # row_threads, max_iter, minsum, alpha, beta, stream
    "ldpc_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                    ctypes.c_float, _P),
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


def build_commands(out: pathlib.Path, obj_dir: pathlib.Path
                   ) -> tuple[list[list[str]], list[str]]:
    """The nvcc command lines that build the kernel library at `out`: one
    compile per source (objects in `obj_dir`), then the link."""
    objs = [obj_dir / f"{p.stem}.o" for p in source_paths()]
    compiles = [[_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-c", "-o", str(obj), str(src)]
                for src, obj in zip(source_paths(), objs)]
    link = [_nvcc(), "-gencode", ARCH, "-shared", "-o", str(out),
            *[str(o) for o in objs]]
    return compiles, link


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libmercury_kernels_{source_hash()}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with nvcc's errors if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{cmd[-1]}: nvcc failed ({proc.returncode}):\n"
                          f"{stderr}")
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build in a private directory and rename: a concurrent process
        # never loads a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib_tmp = pathlib.Path(tmp) / out.name
            compiles, link = build_commands(lib_tmp, pathlib.Path(tmp))
            _run_all(compiles)
            _run_all([link])
            os.replace(lib_tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
