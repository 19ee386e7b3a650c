"""The port's own copies of the JAX package's numpy-only modules: the mode
table (`modes`), CRC16 (`crc`), the glibc PRNG (`prng`), host DSP
(`hostdsp`) and the per-mode geometry (`geometry`), with `fec/tables.py` and
`data/ldpc_tables.npz` beside them. They run on the host at construction
time; tests/test_torch_core.py holds each equal to its original."""
