"""Devices and host copies of the PyTorch port.

`resolve_device` is the device rule of every entry point: the card unless
the caller names another device, and no silent fall-back to the CPU;
`cli_device` is that rule behind a command-line tool's --cpu flag, and
`describe`/`card_meta` name the device beside a tool's numbers.
`host_rows` brings a batch of per-row results to the host in one copy.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device` as given, else the CUDA card. Without a GPU, leaving the
    device out raises: the CPU (the kernels' plain versions) is had only by
    asking for it with device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mercury_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return torch.device("cuda")


def cli_device(cpu: bool) -> torch.device | None:
    """The device a tool's --cpu flag asks for: the CPU, else the card.
    None (the message on stderr) when there is no card and --cpu was not
    given: the tool then exits 1, it never falls back to the CPU."""
    try:
        return resolve_device("cpu" if cpu else None)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def describe(device: torch.device) -> dict:
    """{"backend": "torch-cuda" or "torch-cpu", "device": the card's name
    or "cpu"}: what every result of the port's measuring tools names."""
    if device.type == "cuda":
        return {"backend": "torch-cuda",
                "device": torch.cuda.get_device_name(device)}
    return {"backend": "torch-cpu", "device": "cpu"}


def card_meta(device: torch.device) -> dict:
    """describe(device), the torch version and, on the card, the CUDA
    version, the card count and nvidia-smi's name and power limit (a card
    set below its maximum runs slower under load): what a qualification
    record names beside its numbers."""
    out = {**describe(device), "torch": torch.__version__}
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        out.update(cuda=torch.version.cuda, count=torch.cuda.device_count(),
                   name_power_limit=smi.stdout.strip().splitlines()[0])
    return out


def host_rows(*cols: torch.Tensor) -> np.ndarray:
    """Per-row results ([B] or [B, k] each; bool, uint8, int32 or float32,
    on any device) -> one float64 host array [B, sum of widths] in a single
    copy (one synchronize). float64 holds each of those types exactly."""
    return torch.cat([c.reshape(c.shape[0], -1).to(torch.float64)
                      for c in cols], dim=1).cpu().numpy()
