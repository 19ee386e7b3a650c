"""Carry the per-mode receive constants across from the JAX package.

This system has no learned weights: an `RxChain`'s state is the set of
constants its constructor builds from the mode geometry (FIR taps, matched-
filter templates, pilot DFT and estimation operators, index permutations,
CRC affine maps). `rx_state_from_numpy` turns those constants, taken out of
a JAX `RxChain` (`mercury_tpu/modem/rx.py`) as numpy arrays, into the buffers of
`mercury_tpu_torch.modem.rx.RxChain`, which builds its own through the same
function, so `RxChain.load_state_dict` accepts the result.

`resolve_device` is the device rule of every entry point: the card unless
the caller names another device, and no silent fall-back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"real": torch.float32, "complex": torch.complex64,
           "index": torch.int64}

# receive-chain buffer name (as in both packages) -> kind
RX_BUFFERS = {
    "_fir_ts": "real", "_fir_data": "real",
    "_mf_templates": "complex", "_pil_templates": "complex",
    "_pilot_seq": "complex", "_const": "complex",
    "_pil_dft_op": "complex",
    "_est_op": "real", "_est_pil_op": "real", "_loo_op": "real",
    "_dd_box_s": "real", "_dd_box_c": "real",
    "_pil_bins": "real", "_cell_bins": "real",
    "_crc_a": "real", "_crc_c0": "index",
    "_pad_map": "index", "_pilot_cells": "index", "_data_cells": "index",
    "_pil_slot": "index", "_tf_iperm": "index", "_bit_iperm": "index",
    "_tf_perm": "index", "_bit_perm": "index", "_dd_src": "index",
    "_dispersal": "index",
    "_ramp_a": "index", "_ramp_b": "index",
    "_ramp2_a": "index", "_ramp2_b": "index",
}


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


def rx_state_from_numpy(d: dict[str, np.ndarray],
                        device=None) -> dict[str, torch.Tensor]:
    """numpy receive constants (names of RX_BUFFERS) -> tensors of the
    port's buffer types (float32, complex64, int64) on `device` (the card
    unless given; see resolve_device)."""
    unknown = set(d) - set(RX_BUFFERS)
    if unknown:
        raise ValueError(f"not receive-chain buffers: {sorted(unknown)}")
    device = resolve_device(device)
    return {name: torch.as_tensor(np.array(arr)).to(
                dtype=_DTYPES[RX_BUFFERS[name]], device=device)
            for name, arr in d.items()}
