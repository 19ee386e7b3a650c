"""Share of its roofline (%) of the front end's mixer and decimating FIR
kernel in the profiled stretch (the whole-buffer sync FIR and the frame's
data FIR): the least time their shapes' bytes or operations need
(benchmark/yardstick.py) over the device time of the operations named
mix_fir_decimate."""

NAME = "mix_fir_decimate"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    bound = sum(tr.launches.get(NAME, []))
    busy_ms = sum(e - s for n, s, e in tr.device_ops if NAME in n) * 1e-3
    return 100.0 * bound / busy_ms if bound and busy_ms else None
