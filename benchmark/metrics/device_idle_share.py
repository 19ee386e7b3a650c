"""1 - the union of the device's busy intervals (kernels and copies) over
the profiled stretch's wall time on the host clock (share)."""

from benchmark.yardstick import busy_union


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    busy, _ = busy_union([(s, e) for _, s, e in tr.device_ops], tr.lo, tr.hi)
    return 1.0 - busy * 1e-6 / tr.wall_s
