"""Host ms a round of the program's `rx.read` spans in the profiled
stretch: every read of a device value inside the receive (the recovery
loop's rows, the rescue test), the host waiting on the card inside
round() (ms; 0 where the receive reads nothing)."""

from benchmark import spans


def read(run):
    st = spans.stretch(run)
    return None if st is None else st.host_ms("rx.read")
