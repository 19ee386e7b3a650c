"""Mercury's modulation/config ladder ("model zoo") as frozen data.

Mirrors the reference's central mode table
(reference: source/physical_layer/telecom_system.cc:2487-2645, init tables
:1804-1876, ladder include/common/common_defines.h:41-127).
"""

from __future__ import annotations

from dataclasses import dataclass

# Modulation identifiers (reference: include/physical_layer/psk.h:29-34, mfsk.h:29)
MOD_BPSK = 2
MOD_QPSK = 4
MOD_8PSK = 8
MOD_16QAM = 16
MOD_32QAM = 32
MOD_64QAM = 64
MOD_MFSK = 200

# Channel estimators (reference: include/physical_layer/physical_defines.h:68-69)
ZERO_FORCE = 0
LEAST_SQUARE = 1

# Pilot densities (physical_defines.h:74-75)
HIGH_DENSITY = 0
LOW_DENSITY = 1

# Config ids (common_defines.h:41-65)
CONFIG_NONE = -1
ROBUST_0 = 100
ROBUST_1 = 101
ROBUST_2 = 102

OFDM_CONFIGS = list(range(17))
ROBUST_CONFIGS = [ROBUST_0, ROBUST_1, ROBUST_2]
ALL_CONFIGS = OFDM_CONFIGS + ROBUST_CONFIGS

# Unified gearshift ladder (CONFIG_16 excluded — common_defines.h:74-80)
FULL_CONFIG_LADDER = ROBUST_CONFIGS + list(range(16))


@dataclass(frozen=True)
class ModeSpec:
    """Static per-config parameters (the reference's load_configuration table)."""
    config: int
    modulation: int
    ldpc_rate_num: int           # rate = num/16
    preamble_nsymb: int
    channel_estimator: int
    mfsk_m: int = 0              # MFSK tones per stream (0 for OFDM modes)
    mfsk_nstreams: int = 0
    ctrl_nbits: int = 0          # punctured control-frame bits (MFSK only)

    @property
    def ldpc_rate(self) -> float:
        return self.ldpc_rate_num / 16.0

    @property
    def ldpc_k(self) -> int:
        return int(1600 * self.ldpc_rate_num / 16.0)

    @property
    def is_mfsk(self) -> bool:
        return self.modulation == MOD_MFSK

    @property
    def amplitude_restoration(self) -> bool:
        # PSK modes restore channel amplitude (telecom_system.cc:2647-2654)
        return self.modulation in (MOD_BPSK, MOD_QPSK, MOD_8PSK)


_T = [
    # cfg, modulation, rate_num, preambles, estimator
    (0, MOD_BPSK, 1, 4, LEAST_SQUARE),
    (1, MOD_BPSK, 2, 4, LEAST_SQUARE),
    (2, MOD_BPSK, 3, 4, LEAST_SQUARE),
    (3, MOD_BPSK, 4, 4, LEAST_SQUARE),
    (4, MOD_BPSK, 5, 4, LEAST_SQUARE),
    (5, MOD_BPSK, 6, 4, LEAST_SQUARE),
    (6, MOD_BPSK, 8, 4, LEAST_SQUARE),
    (7, MOD_QPSK, 5, 4, LEAST_SQUARE),
    (8, MOD_QPSK, 6, 4, LEAST_SQUARE),
    (9, MOD_QPSK, 8, 4, LEAST_SQUARE),
    (10, MOD_8PSK, 6, 3, LEAST_SQUARE),
    (11, MOD_8PSK, 8, 3, LEAST_SQUARE),
    (12, MOD_QPSK, 14, 3, LEAST_SQUARE),
    (13, MOD_16QAM, 8, 2, LEAST_SQUARE),
    (14, MOD_8PSK, 14, 2, LEAST_SQUARE),
    (15, MOD_16QAM, 14, 2, ZERO_FORCE),
    (16, MOD_32QAM, 14, 1, ZERO_FORCE),
]

MODES: dict[int, ModeSpec] = {
    cfg: ModeSpec(cfg, mod, rn, pre, est) for cfg, mod, rn, pre, est in _T
}
# ROBUST modes: 32-MFSK x1 / 16-MFSK x2 (telecom_system.cc:2625-2645,2695-2707)
MODES[ROBUST_0] = ModeSpec(ROBUST_0, MOD_MFSK, 1, 4, LEAST_SQUARE, 32, 1, 1200)
MODES[ROBUST_1] = ModeSpec(ROBUST_1, MOD_MFSK, 1, 4, LEAST_SQUARE, 16, 2, 1400)
MODES[ROBUST_2] = ModeSpec(ROBUST_2, MOD_MFSK, 4, 4, LEAST_SQUARE, 16, 2, 0)


def get_configuration(snr_db: float) -> int:
    """SNR -> recommended config (reference: telecom_system.cc:3036-3106)."""
    ladder = [
        (12.5, 15), (9, 14), (7.5, 13), (6.5, 12), (4, 11), (3, 10),
        (1.5, 9), (0.5, 8), (-0.5, 7), (-1.5, 6), (-2.5, 5), (-3.5, 4),
        (-4.5, 3), (-6, 2), (-7.5, 1),
    ]
    for thresh, cfg in ladder:
        if snr_db > thresh:
            return cfg
    return 0


def ladder_index(config: int) -> int:
    return FULL_CONFIG_LADDER.index(config) if config in FULL_CONFIG_LADDER else -1


def ladder_up(config: int, robust_enabled: bool = True) -> int:
    if not robust_enabled:
        return config + 1 if config < 15 else config
    i = ladder_index(config)
    if 0 <= i < len(FULL_CONFIG_LADDER) - 1:
        return FULL_CONFIG_LADDER[i + 1]
    return config


def ladder_down(config: int, steps: int = 1, robust_enabled: bool = True) -> int:
    if not robust_enabled:
        return max(0, config - steps)
    i = max(0, ladder_index(config) - steps)
    return FULL_CONFIG_LADDER[i]
