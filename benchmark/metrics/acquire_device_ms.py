"""The card's ms a round of the program's `rx.acquire` spans in the
profiled stretch: from the CUDA event before RxChain.receive's front end,
sync and refinement to the one after them on the current stream, queueing
included (ms)."""

from benchmark import spans


def read(run):
    st = spans.stretch(run)
    return None if st is None else st.device_ms_of("rx.acquire")
