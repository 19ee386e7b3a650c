"""Which rows the narrow CFO range loses at a given Es/N0, in the JAX chain
and in the port (CPU, plain versions): `batch` frames of one mode, half
shifted by +offset Hz and half by -offset (sim.apply_cfo), in white noise
at the bench.py delay; each chain's receive reports its failed rows.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/narrow_cfo_reference.py \
        --config 0 --esn0 12 --batch 64 --offset 30
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mercury_tpu.core.geometry import build_geometry as jax_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0)
    ap.add_argument("--esn0", type=float, default=12.0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--offset", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    a = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    g = build_geometry(a.config)
    gen = torch.Generator().manual_seed(a.seed)
    payload = torch.randint(0, 256, (a.batch, g.frame_bytes), generator=gen,
                            dtype=torch.uint8)
    frames = TxChain(g, device="cpu").transmit(payload)
    half = a.batch // 2
    frames = torch.cat([sim.apply_cfo(frames[:half], g.fs, g.fc, a.offset),
                        sim.apply_cfo(frames[half:], g.fs, g.fc, -a.offset)])
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = sim.awgn_passband(frames, sim.sigma_for_esn0(a.esn0), delay,
                            g.nofdm * g.buffer_nsymb * g.interp, gen)
    for label, rx in (("port narrow", RxChain(g, device="cpu",
                                               cfo_range="narrow")),
                      ("port wide", RxChain(g, device="cpu"))):
        ok = rx.receive(buf).crc_ok.numpy()
        print(f"CONFIG_{a.config} at {a.esn0} dB, +-{a.offset} Hz, "
              f"{a.batch} rows: {label} fails rows "
              f"{np.nonzero(~ok)[0].tolist()}")
    res = JaxRx(jax_geometry(a.config), cfo_range="narrow").receive(
        jnp.asarray(buf.numpy()))
    print(f"CONFIG_{a.config} at {a.esn0} dB, +-{a.offset} Hz, {a.batch} "
          f"rows: JAX narrow fails rows "
          f"{np.nonzero(~np.asarray(res.crc_ok))[0].tolist()}")


if __name__ == "__main__":
    main()
