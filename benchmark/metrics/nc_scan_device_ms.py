"""The card's ms a round of the program's `rx.nc_scan` spans in the
profiled stretch: from the CUDA event before CONFIG_1-4's noncoherent
whole-buffer scan to the one after its best lags (the segment cut, the CFO
grid's bank, the matched-filter scores and their argmax and gather),
queueing included (ms). None where the program runs no such scan."""

from benchmark import spans


def read(run):
    st = spans.stretch(run)
    return None if st is None else st.device_ms_of("rx.nc_scan")
