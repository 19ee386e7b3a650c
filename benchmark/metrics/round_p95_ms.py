"""95th percentile, by nearest rank over every round of the window, of the
time from a round's round() call to its results returned by unpack (ms):
how long a station's frame waits before its bytes reach the ARQ layer."""

from benchmark.yardstick import nearest_rank


def read(run):
    return nearest_rank([(c - a) * 1e3 for a, _, c, _ in run.rounds], 0.95)
