"""Mean host time of FusedDevicePool.round() (ms) over the window's rounds
before the profiled stretch: the dispatch of a whole round, the benchmark's
own span around the call."""


def read(run):
    before = run.rounds[:len(run.rounds) - run.traced_rounds]
    spans = [(b - a) * 1e3 for a, b, _, _ in before]
    return sum(spans) / len(spans) if spans else None
