#!/usr/bin/env python3
"""Profile mercury_tpu_torch's RxChain.receive on one CUDA card.

    PYTHONPATH=. python3 tools/profile_torch_rx.py --config 16 --esn0 31 20.5 \
        [--out DIR]

For each Es/N0 (an MFSK mode's channel SNR: --config 100 --esn0 -9 -13;
--ctrl: its control frames): a
batch-256 capture buffer (chip_smoke.make_buffer, seed 160), one first
decode per row with DD and BICM-ID off, or on an MFSK mode without the
runner-up sync candidate (to count the rows it loses), 3 warm-up receives, 10 timed receives (host clock around the
receive, ending in a synchronize: min / median / max), then one receive
under torch.profiler: device busy (the table's "Self CUDA time total"; a
sum over rows would count an aten op and its kernel twice), idle share =
1 - busy / median receive, self CPU total and the top device items. With
--out, the table's top 25 rows go to DIR/profile_cfg<config>_<esn0>.txt.
Needs a card; exits 1 without one.
"""

import argparse
import pathlib
import re
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import BATCH, make_buffer
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain

_UNIT_MS = {"s": 1e3, "ms": 1.0, "us": 1e-3}


def total_ms(table: str, label: str) -> float:
    m = re.search(label + r" time total: ([\d.]+)(s|ms|us)", table)
    return float(m.group(1)) * _UNIT_MS[m.group(2)]


def timed(rx: RxChain, buf: torch.Tensor) -> float:
    t0 = time.perf_counter()
    rx.receive(buf)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_point(cfg: int, esn0: float, dev: torch.device,
                  out: pathlib.Path | None, ctrl: bool = False) -> None:
    g = build_geometry(cfg)
    rx = RxChain(g, device=dev, ctrl=ctrl)
    plain = (RxChain(g, device=dev, ctrl=ctrl, mfsk_sync_cands=1)
             if g.spec.is_mfsk
             else RxChain(g, device=dev, dd=False, bicm_iters=0))
    buf, payload, _delay = make_buffer(g, dev, esn0, 160, ctrl)
    first_ok = plain.receive(buf).crc_ok
    for _ in range(3):
        res = rx.receive(buf)
    torch.cuda.synchronize()
    rx.reset_recovery()
    times = [timed(rx, buf) for _ in range(10)]
    rec = {k: v // 10 for k, v in rx.recovery.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rx.receive(buf)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        tag = "_ctrl" if ctrl else ""
        (out / f"profile_cfg{cfg}{tag}_{esn0}.txt").write_text(table)
    busy = total_ms(table, "Self CUDA")
    med = statistics.median(times)
    ok = res.crc_ok
    print(f"CONFIG_{cfg}{' ctrl' if ctrl else ''} at {esn0} dB, batch "
          f"{BATCH}: "
          f"{int(ok.sum())}/{BATCH} decoded "
          f"(payloads equal: {bool(torch.equal(res.payload[ok], payload[ok]))}"
          f"); first decode failed on {int((~first_ok).sum())} rows, "
          f"recovered {int((ok & ~first_ok).sum())}; BICM-ID / DD / MFSK "
          f"runner-up rows a receive {rec['bicm_rows']} / {rec['dd_rows']} / "
          f"{rec['mfsk_rows']}; iters mean "
          f"{res.iters.double().mean().item():.3f}")
    print(f"  receive ms min / median / max of 10: {min(times):.2f} / "
          f"{med:.2f} / {max(times):.2f}; profiled receive: device busy "
          f"{busy:.3f} ms, idle share {1 - busy / med:.3f}, self CPU "
          f"{total_ms(table, 'Self CPU'):.3f} ms")
    print("\n".join(table.splitlines()[:14]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=16)
    ap.add_argument("--esn0", type=float, nargs="+", default=[31.0])
    ap.add_argument("--ctrl", action="store_true")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_rx: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    for esn0 in args.esn0:
        profile_point(args.config, esn0, dev, args.out, args.ctrl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
