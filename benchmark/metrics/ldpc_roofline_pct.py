"""Share of its roofline (%) of the LDPC decode kernel in the profiled
stretch: the least time the launches' work could take (FP32 operations at
the sweeps each launch's rows reported, or bytes; benchmark/yardstick.py)
over the device time of the operations named ldpc_layered."""

NAME = "ldpc_layered"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    bound = sum(tr.launches.get(NAME, []))
    busy_ms = sum(e - s for n, s, e in tr.device_ops if NAME in n) * 1e-3
    return 100.0 * bound / busy_ms if bound and busy_ms else None
