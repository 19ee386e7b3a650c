"""The card's ms a round of the program's `rx.decode` spans in the
profiled stretch: from event to event around the receive's first decode
(demod, estimate, demap, LDPC, BICM-ID/DD recovery, CRC) and the rescue
decode, queueing included (ms)."""

from benchmark import spans


def read(run):
    st = spans.stretch(run)
    return None if st is None else st.device_ms_of("rx.decode")
