"""Host ms a round of the program's `pool.unpack.build` spans in the
profiled stretch: FusedDevicePool.unpack after its D2H copy, the columns
and the per-channel RxResults (ms)."""

from benchmark import spans


def read(run):
    st = spans.stretch(run)
    return None if st is None else st.host_ms("pool.unpack.build")
