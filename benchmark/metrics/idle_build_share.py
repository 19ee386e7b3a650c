"""The share of the device's idle time in the profiled stretch that falls
inside the program's `pool.unpack.build` spans: the gaps between busy
intervals (benchmark/yardstick.py's busy union) overlapped with the build
spans, over all the gaps (share; 0 when the device never idles)."""

from benchmark import spans
from benchmark.yardstick import busy_union


def read(run):
    st = spans.stretch(run)
    tr = run.trace
    if st is None or not tr.device_ops:
        return None
    _, gaps = busy_union([(s, e) for _, s, e in tr.device_ops], tr.lo, tr.hi)
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return 0.0
    m = st.of("pool.unpack.build")
    inside = sum(max(0.0, min(e, be) - max(s, bs))
                 for s, e in gaps for bs, be in zip(st.start[m], st.end[m]))
    return inside / idle
