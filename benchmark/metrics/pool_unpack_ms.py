"""Mean host time of FusedDevicePool.unpack() (ms), its one device-to-host
wait included, over the window's rounds before the profiled stretch: the
benchmark's own span around the call."""


def read(run):
    before = run.rounds[:len(run.rounds) - run.traced_rounds]
    spans = [(c - b) * 1e3 for _, b, c, _ in before]
    return sum(spans) / len(spans) if spans else None
