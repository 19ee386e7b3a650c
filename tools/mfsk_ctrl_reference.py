#!/usr/bin/env python3
"""MFSK frames through the JAX package and the PyTorch port on the CPU, on
the same numpy capture buffers: how many rows each decodes, and whether
they decode the same rows.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/mfsk_ctrl_reference.py \
        --config 100 --snr -12 [--data] [--rows 256]

Control frames (or data frames with --data) of random payloads at the
symbol-aligned delay of tests/test_rx.py:137, in white noise at --snr dB
channel SNR (sim.sigma_for_channel_snr), seed 2024, decoded 32 rows at a
time by both chains with default options. A row counts as decoded when its
CRC passes and its payload equals the one sent. It tells the port's
behaviour from the reference's at a batch the unit tests do not reach
(chip_smoke.py holds the card at batch 256).
"""

import argparse

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mercury_tpu.core.geometry import build_geometry  # noqa: E402
from mercury_tpu.modem.rx import RxChain as JaxRx  # noqa: E402
from mercury_tpu.modem.tx import TxChain as JaxTx  # noqa: E402
from mercury_tpu_torch.channel import sim  # noqa: E402
from mercury_tpu_torch.core.geometry import (  # noqa: E402
    build_geometry as port_geometry)
from mercury_tpu_torch.modem.rx import RxChain  # noqa: E402

CHUNK = 32


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=100)
    ap.add_argument("--snr", type=float, default=-12.0)
    ap.add_argument("--data", action="store_true",
                    help="data frames instead of control frames")
    ap.add_argument("--rows", type=int, default=256)
    args = ap.parse_args()
    torch.set_num_threads(2)
    ctrl = not args.data
    g = build_geometry(args.config)
    jax_tx, jax_rx = JaxTx(g, ctrl=ctrl), JaxRx(g, ctrl=ctrl)
    rx = RxChain(port_geometry(args.config), device="cpu", ctrl=ctrl)
    rng = np.random.default_rng(2024)
    n = g.nofdm * g.buffer_nsymb * g.interp
    delay = (g.preamble_nsymb + 2) * g.nofdm * g.interp
    ok_jax = ok_port = same = 0
    for _ in range(args.rows // CHUNK):
        payload = rng.integers(0, 256, (CHUNK, g.frame_bytes)).astype(np.uint8)
        frames = np.asarray(jax_tx.transmit(payload))
        sigma = sim.sigma_for_channel_snr(frames[0], args.snr, g.fs,
                                          g.bandwidth)
        buf = rng.standard_normal((CHUNK, n)) * sigma
        buf[:, delay: delay + frames.shape[1]] += frames
        buf = buf.astype(np.float32)
        res_j = jax_rx.receive(jnp.asarray(buf))
        res = rx.receive(torch.as_tensor(buf))
        good_j = (np.asarray(res_j.crc_ok)
                  & (np.asarray(res_j.payload) == payload).all(1))
        good = res.crc_ok.numpy() & (res.payload.numpy() == payload).all(1)
        ok_jax += int(good_j.sum())
        ok_port += int(good.sum())
        same += int((good_j == good).sum())
    kind = "control" if ctrl else "data"
    print(f"CONFIG_{args.config} {kind} frames at {args.snr} dB channel SNR, "
          f"{args.rows // CHUNK * CHUNK} rows: JAX decoded {ok_jax}, port "
          f"{ok_port}, rows with the same outcome {same}")


if __name__ == "__main__":
    main()
