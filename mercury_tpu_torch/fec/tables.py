"""LDPC code definitions (IRA, N=1600, rates 1/16..14/16).

Loads the adjacency/generator archive produced by tools/convert_ldpc_tables.py
(data extracted from the reference's mercury_normal_*.cc code tables — the
identical parity-check matrices are required for interoperability). The port's
own copy of the JAX package's fec/tables.py, reading its own copy of the
archive under mercury_tpu_torch/data/.
"""

from __future__ import annotations

import functools
import pathlib
from dataclasses import dataclass

import numpy as np

N = 1600
_RATE_TAG = {1: "1_16", 2: "2_16", 3: "3_16", 4: "4_16", 5: "5_16",
             6: "6_16", 8: "8_16", 14: "14_16"}

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data" / "ldpc_tables.npz"


@dataclass(frozen=True)
class LdpcCode:
    """One rate of the Mercury IRA LDPC family (all arrays are host numpy)."""
    k: int
    p: int
    c_idx: np.ndarray    # [P, Cw] check -> variable indices (-1 pad)
    v_idx: np.ndarray    # [N, Vw] variable -> check indices (-1 pad)
    v_pos: np.ndarray    # [P, Cw] slot of check i within V[v] (-1 pad)
    deg: np.ndarray      # [N] variable degrees
    gen: np.ndarray      # [P, K] uint8 generator block: parity = G @ u mod 2

    @property
    def n(self) -> int:
        return N

    @property
    def cw(self) -> int:
        return self.c_idx.shape[1]

    @property
    def vw(self) -> int:
        return self.v_idx.shape[1]


@functools.lru_cache(maxsize=None)
def load_code(rate_num: int) -> LdpcCode:
    tag = _RATE_TAG[rate_num]
    z = np.load(_DATA)
    k = int(z[f"{tag}_K"])
    return LdpcCode(
        k=k, p=N - k,
        c_idx=z[f"{tag}_C"], v_idx=z[f"{tag}_V"], v_pos=z[f"{tag}_Vpos"],
        deg=z[f"{tag}_deg"], gen=z[f"{tag}_G"],
    )
