"""Rows re-decoded a round in the profiled stretch: the n of the
program's `rx.recovery` spans summed (one a BICM-ID, DD or runner-up pass,
n its failed rows; rows/round, 0 where no pass ran)."""

from benchmark import spans


def read(run):
    st = spans.stretch(run)
    return None if st is None else st.count("rx.recovery")
