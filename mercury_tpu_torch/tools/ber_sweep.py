"""BER/FER sweeps across the mode ladder with the port's BerHarness (the
counterpart of the repo root's tools/ber_sweep.py), written to JSON.

    python -m mercury_tpu_torch.tools.ber_sweep out.json [--configs 0,1,...] \\
        [--frames N] [--batch B] [--cpu]

Each config's grid (the JAX tool's) is swept from its highest point down,
on the CUDA card unless --cpu is given; the output is rewritten after every
config. Without a card and without --cpu it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

from mercury_tpu_torch.channel.ber import BerHarness
from mercury_tpu_torch.convert import card_meta, cli_device

# sweep grids centred on each mode's measured operating region
GRIDS = {
    0: [0, 1, 2, 3, 4], 1: [1, 2, 3, 4, 5], 2: [2, 3, 4, 5, 6],
    3: [3, 4, 5, 6, 7], 4: [4, 5, 6, 7, 8], 5: [4, 5, 6, 7, 8],
    6: [5, 6, 7, 8, 9], 7: [6, 7, 8, 9, 10], 8: [7, 8, 9, 10, 11],
    9: [8, 9, 10, 11, 12], 10: [10, 11, 12, 13, 14], 11: [11, 12, 13, 14, 15],
    12: [13, 14, 15, 16, 17], 13: [14, 15, 16, 17, 18],
    14: [16, 17, 18, 19, 20], 15: [22, 24, 26, 28], 16: [26, 28, 30, 32],
    100: [-16, -15, -14, -13, -12], 101: [-14, -13, -12, -11, -10],
    102: [-11, -10, -9, -8, -7],
}


def sweep_config(cfg: int, frames: int, batch: int, device) -> dict:
    """One config's sweep over GRIDS[cfg] -> the JAX tool's entry:
    {"points": [...], "waterfall_fer10": ...}."""
    h = BerHarness(cfg, batch=batch, device=device)
    sweep = h.sweep(sorted(GRIDS[cfg], reverse=True), n_frames=frames,
                    verbose=True)
    return {"points": [{"esn0_db": p.esn0_db, "fer": p.fer, "ber": p.ber,
                        "frames": p.frames} for p in sweep.points],
            "waterfall_fer10": sweep.waterfall(0.1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.tools.ber_sweep",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("out")
    ap.add_argument("--configs", default=None)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1
    configs = ([int(c) for c in args.configs.split(",")] if args.configs
               else list(GRIDS))
    results = {"meta": card_meta(device)}
    for cfg in configs:
        results[str(cfg)] = sweep_config(cfg, args.frames, args.batch,
                                         device)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"cfg{cfg}: waterfall(FER<0.1) = "
              f"{results[str(cfg)]['waterfall_fer10']}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
