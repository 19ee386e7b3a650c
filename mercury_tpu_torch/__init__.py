"""mercury-tpu on PyTorch and CUDA: the OFDM transmit/receive chain of
`mercury_tpu` written as eager PyTorch, with hand-written CUDA kernels for
the front end and the acquisition on its path (`dsp.kernels`).

The port keeps its own copies of the JAX package's numpy-only modules (mode
table, geometry, CRC, PRNG, host DSP in `core/`, the LDPC tables in
`fec/tables.py` and `data/`) and imports neither JAX nor `mercury_tpu`.
Entry points: `modem.tx.TxChain`, `channel.sim.awgn_passband` and
`modem.rx.RxChain`; they run on the CUDA card unless the caller passes
device="cpu", which runs the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
