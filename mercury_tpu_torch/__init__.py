"""mercury-tpu on PyTorch and CUDA: the OFDM transmit/receive chain of
`mercury_tpu` written as eager PyTorch, with hand-written CUDA kernels for
the two front-end/acquisition kernels on its path (`dsp.kernels`).

The numpy-only modules of the JAX package (mode table, geometry, CRC, PRNG,
host DSP and the LDPC tables) are imported from `mercury_tpu`, never copied;
nothing here imports JAX. Entry points: `modem.tx.TxChain`,
`channel.sim.awgn_passband` and `modem.rx.RxChain`.
"""

__version__ = "0.1.0"
