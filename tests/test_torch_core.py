"""The port's own copies of the numpy-only modules against the JAX
package's originals: geometry for every config of the mode table, the LDPC
tables for every rate, CRC16, the glibc PRNG and the FIR design, all equal
exactly (np.array_equal on arrays, == on scalars)."""

import dataclasses

import numpy as np
import pytest

from mercury_tpu.core import crc as jcrc
from mercury_tpu.core import geometry as jgeometry
from mercury_tpu.core import hostdsp as jhostdsp
from mercury_tpu.core import modes as jmodes
from mercury_tpu.core import prng as jprng
from mercury_tpu.fec import tables as jtables
from mercury_tpu_torch.core import crc, geometry, hostdsp, modes, prng
from mercury_tpu_torch.fec import tables

CASES = ([(cfg, True) for cfg in sorted(jmodes.MODES)]
         + [(cfg, False) for cfg in (0, 3, 9)])


def _assert_same(got, want, path="geometry"):
    """Field-by-field exact equality across the two packages' classes."""
    if dataclasses.is_dataclass(want):
        assert dataclasses.is_dataclass(got), path
        assert type(got).__name__ == type(want).__name__, path
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, path
        for name in names:
            _assert_same(getattr(got, name), getattr(want, name),
                         f"{path}.{name}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, path


def test_mode_table_equal():
    assert sorted(modes.MODES) == sorted(jmodes.MODES)
    for cfg, spec in jmodes.MODES.items():
        _assert_same(modes.MODES[cfg], spec, f"MODES[{cfg}]")


@pytest.mark.parametrize("cfg,pre_eq", CASES,
                         ids=[f"cfg{c}-{'pre_eq' if p else 'no_pre_eq'}"
                              for c, p in CASES])
def test_build_geometry_equal(cfg, pre_eq):
    got = geometry.build_geometry(cfg, with_pre_eq=pre_eq)
    want = jgeometry.build_geometry(cfg, with_pre_eq=pre_eq)
    _assert_same(got, want)
    # the cache returns the same object, as the original's does
    assert geometry.build_geometry(cfg, with_pre_eq=pre_eq) is got


@pytest.mark.parametrize("rate", sorted(jtables._RATE_TAG))
def test_load_code_equal(rate):
    _assert_same(tables.load_code(rate), jtables.load_code(rate), "code")


def test_crc_equal():
    rng = np.random.default_rng(16)
    for nbytes in (1, 7, 64, 200):
        data = rng.integers(0, 256, nbytes)
        assert crc.crc16(data) == jcrc.crc16(data)
        _assert_same(crc.crc_affine(nbytes), jcrc.crc_affine(nbytes), "crc")
        bits = crc.bytes_to_bits(data)
        _assert_same(bits, jcrc.bytes_to_bits(data), "bits")
        _assert_same(crc.bits_to_bytes(bits), jcrc.bits_to_bytes(bits),
                     "bytes")


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 2])
def test_glibc_random_equal(seed):
    a, b = prng.GlibcRandom(seed), jprng.GlibcRandom(seed)
    _assert_same(a.draw(500), b.draw(500), "draw")
    _assert_same(a.bits(300), b.bits(300), "bits")


@pytest.mark.parametrize("ftype,window", [("lpf", "hamming"),
                                          ("hpf", "blackman"),
                                          ("lpf", "hanning")])
def test_design_fir_equal(ftype, window):
    rng = np.random.default_rng(7)
    for _ in range(3):
        fs = float(rng.uniform(8000.0, 48000.0))
        args = (fs, fs * float(rng.uniform(0.02, 0.1)),
                fs * float(rng.uniform(0.05, 0.4)), ftype, window)
        _assert_same(hostdsp.design_fir(*args), jhostdsp.design_fir(*args),
                     "fir")
