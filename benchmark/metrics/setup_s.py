"""Process start to the first timed round (s): imports, the CUDA context,
the kernels (built on a checkout's first run), the ring of inputs, the
pool and three warm rounds."""


def read(run):
    return run.setup_s
