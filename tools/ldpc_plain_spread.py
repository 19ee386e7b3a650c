#!/usr/bin/env python3
"""How far apart three runs of the same layered LDPC decode end, on one CUDA
card: mercury_tpu_torch's kernel (kernels.ldpc_layered), its plain version
on the card and its plain version on the CPU, on the same LLRs
(roofline.ldpc_mixed_llr: batch 256 at mixed noise, so that some rows
converge within the 50 sweeps and some do not), the posterior out.

    PYTHONPATH=. python3 tools/ldpc_plain_spread.py [--rates 1 8 14] \
        [--algos spa minsum]

For each rate and check update, each pair: rows whose ok differs, rows
converged in both whose bits differ, the largest iters gap on those rows,
and on the rows converged at the same sweep the posterior's largest gap,
its elements beyond rtol 0.3 / atol 1 and its sign flips. Min-sum has no
transcendental: every pair should agree exactly. For SPA a last-ulp
tanh/atanh difference (another library, another product order) steers a
row near the waterfall, so the plain version against itself across
devices is the yardstick for the kernel against the plain version.
Needs a card; exits 1 without one.
"""

import argparse
import subprocess
import sys

import torch

from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.tools.roofline import ldpc_mixed_llr

RATES = (1, 2, 3, 4, 5, 6, 8, 14)


def spread(got, want) -> dict:
    """Where two decodes (bits, iters, ok, posterior) part."""
    bits, iters, ok, post = (t.cpu() for t in got)
    bits_w, iters_w, ok_w, post_w = (t.cpu() for t in want)
    both = ok & ok_w
    same = both & (iters == iters_w)
    gap = (post[same] - post_w[same]).abs()
    beyond = gap > 1.0 + 0.3 * post_w[same].abs()
    return {"ok_differs": int((ok != ok_w).sum()),
            "converged_both": int(both.sum()),
            "bits_differ": int((bits[both] != bits_w[both]).any(-1).sum()),
            "iters_gap": int((iters - iters_w)[both].abs().max())
            if both.any() else 0,
            "same_sweep": int(same.sum()),
            "post_gap": float(gap.max()) if gap.numel() else 0.0,
            "post_beyond": int(beyond.sum()), "post_elems": gap.numel(),
            "sign_flips": int((torch.sign(post[same])
                               != torch.sign(post_w[same])).sum())}


def run(rate: int, algo: str, dev: torch.device) -> dict:
    """The three decodes of one rate and check update -> each pair's
    spread."""
    _cw, llr = ldpc_mixed_llr(rate, 256, seed=rate)
    dec = ldpc.LayeredDecoder(rate, algo=algo)
    args = (dec.max_iter, algo, dec.alpha, dec.beta, True)
    cpu = kernels.layered_decode_ref(llr, dec.plan, *args)
    dec = dec.to(dev)
    x = llr.to(dev)
    kern = dec(x, soft=True)
    card = kernels.layered_decode_ref(x, dec.plan, *args)
    torch.cuda.synchronize()
    return {"kernel vs plain (card)": spread(kern, card),
            "kernel vs plain (CPU)": spread(kern, cpu),
            "plain (card) vs plain (CPU)": spread(card, cpu)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rates", type=int, nargs="+", default=list(RATES))
    ap.add_argument("--algos", nargs="+", default=["spa", "minsum"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ldpc_plain_spread: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.set_num_threads(8)
    dev = torch.device("cuda")
    for rate in args.rates:
        for algo in args.algos:
            for pair, s in run(rate, algo, dev).items():
                print(f"rate {rate}/16 {algo}, {pair}: ok differs on "
                      f"{s['ok_differs']}/256 rows; of {s['converged_both']}"
                      f" converged in both, bits differ on "
                      f"{s['bits_differ']}, iters up to {s['iters_gap']} "
                      f"apart; on {s['same_sweep']} converged at the same "
                      f"sweep the posterior up to {s['post_gap']:.3f} "
                      f"apart, {s['post_beyond']}/{s['post_elems']} "
                      f"elements beyond rtol 0.3 / atol 1, "
                      f"{s['sign_flips']} sign flips")
    return 0


if __name__ == "__main__":
    sys.exit(main())
