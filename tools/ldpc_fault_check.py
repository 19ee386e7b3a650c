#!/usr/bin/env python3
"""Whether the SPA bars that hold mercury_tpu_torch's layered LDPC kernel
against its plain version (roofline.ldpc_agree) catch a planted fault, on
one CUDA card.

    PYTHONPATH=. python3 tools/ldpc_fault_check.py [--rates 1 8 14] \
        [--sweeps 1 2 3 50] [--out FILE.json]

The kernel (csrc/ldpc_layered.cu) is taken as the package builds it, and
built again with one change each into build/mercury_tpu_torch/faults/:
the exclusive product multiplied in another order (sound: the order is
free, so the bars must pass it), the file built with --use_fast_math, the
delta written back without its bfloat16 rounding, and the posterior read
into a check update without its bfloat16 rounding. Each decodes
roofline.ldpc_mixed_llr's batch 256 at each rate (SPA, the posterior out)
after each number of sweeps, beside the plain version on the card on the
same LLRs; the plain version on the CPU is a second sound decode (another
tanh/atanh) at the first three sweep counts. For each: the posterior's
largest gap and its share of elements that are not bit-equal, the rows
whose ok differs, the largest iters gap, and ldpc_agree's verdict. Also,
for each rate, the fewest sweeps a row of the plain decode converged in.
Needs a card and nvcc; exits 1 without a card.
"""

import argparse
import contextlib
import ctypes
import json
import pathlib
import sys

import torch

from mercury_tpu_torch import native
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.tools.roofline import ldpc_agree, ldpc_mixed_llr

RATES = (1, 2, 3, 4, 5, 6, 8, 14)
FAULT_DIR = native.BUILD_DIR / "faults"
# name -> (source edits (old, new), extra nvcc flags, sound?)
BUILDS = {
    "product reordered": ([("(before * pre[k]) * (suf[k] * after)",
                            "before * (pre[k] * (suf[k] * after))")], [],
                          True),
    "fast math": ([], ["--use_fast_math"], False),
    "delta not rounded": ([("ldpc_bf16(r_new[c][k] - r_old[c][k])",
                            "(r_new[c][k] - r_old[c][k])")], [], False),
    "read not rounded": ([("ldpc_bf16(L[v[c][k]]) - r_old[c][k]",
                           "L[v[c][k]] - r_old[c][k]")], [], False),
}


def build_faults() -> dict:
    """Each entry of BUILDS as a shared library of ldpc_layered.cu alone,
    built concurrently -> {name: its ldpc_launch}."""
    src = (native.CSRC / "ldpc_layered.cu").read_text()
    FAULT_DIR.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for i, (name, (edits, flags, _sound)) in enumerate(BUILDS.items()):
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        cu = FAULT_DIR / f"fault{i}.cu"
        cu.write_text(text)
        libs[name] = FAULT_DIR / f"libfault{i}.so"
        cmds.append([native._nvcc(), "-gencode", native.ARCH, "-std=c++17",
                     "-O3", *flags, "-Xcompiler", "-fPIC", "-shared", "-o",
                     str(libs[name]), str(cu)])
    native._run_all(cmds)
    out = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).ldpc_launch
        fn.argtypes = native._SIGNATURES["ldpc_launch"]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


@contextlib.contextmanager
def launching(entry):
    """kernels.ldpc_layered launches `entry` in place of the library's."""
    load = native.load_library
    native.load_library = lambda: type("Lib", (), {"ldpc_launch": entry})
    try:
        yield
    finally:
        native.load_library = load


def readings(got, want, sweeps: int, label: str) -> dict:
    """Where a decode parts from the plain version's, and the verdict."""
    bits, iters, ok, post = got
    post_p = want[3].to(post.device)
    gap = (post - post_p).abs()
    both = ok & want[2].to(ok.device)
    out = {"post_gap": float(gap.max()),
           "post_off_share": float((post != post_p).double().mean()),
           "ok_differs": int((ok != want[2].to(ok.device)).sum()),
           "iters_gap": int((iters - want[1].to(iters.device)).abs().max()),
           "bits_differ_rows": int((bits[both] != want[0].to(bits.device)[
               both]).any(-1).sum())}
    try:
        ldpc_agree(got, tuple(t.to(post.device) for t in want), "spa",
                   label, sweeps)
        out["verdict"] = "passes"
    except AssertionError as e:
        out["verdict"] = f"fails: {str(e).splitlines()[0][:120]}"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rates", type=int, nargs="*", default=list(RATES))
    ap.add_argument("--sweeps", type=int, nargs="*", default=[1, 2, 3, 50])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ldpc_fault_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    entries = {"as built": native.load_library().ldpc_launch,
               **build_faults()}
    rows = []
    for rate in args.rates:
        _cw, llr_cpu = ldpc_mixed_llr(rate, 256, seed=rate)
        llr = llr_cpu.to(dev)
        for sweeps in args.sweeps:
            dec = ldpc.LayeredDecoder(rate, sweeps).to(dev)
            want = kernels.layered_decode_ref(llr, dec.plan, sweeps,
                                              soft=True)
            if sweeps == max(args.sweeps):
                it = want[1][want[2] & (want[1] > 0)]
                print(f"rate {rate}/16: fewest sweeps of a converged row "
                      f"{int(it.min()) if it.numel() else None}, rows "
                      f"converged within 3 sweeps "
                      f"{int((it <= 3).sum())}/256")
            runs = {}
            for name, entry in entries.items():
                with launching(entry):
                    runs[name] = dec(llr, soft=True)
            if sweeps <= 3:
                runs["plain on the CPU"] = kernels.layered_decode_ref(
                    llr_cpu, ldpc.pack_plan(rate), sweeps, soft=True)
            torch.cuda.synchronize()
            for name, got in runs.items():
                r = {"rate": rate, "sweeps": sweeps, "build": name,
                     **readings(got, want, sweeps,
                                f"rate {rate} {sweeps} sweeps {name}")}
                rows.append(r)
                print(json.dumps(r))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
