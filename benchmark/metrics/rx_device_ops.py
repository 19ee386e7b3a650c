"""Device operations (kernels, copies, fills) a round in the profiled
stretch, from torch.profiler's device events (ops/round)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.rounds:
        return None
    n = len(tr.device_ops)
    return n / tr.rounds if n else None
