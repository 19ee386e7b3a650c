"""Capture samples of every round completed in the window, over all the
channels, per second of the window's wall time (Msamples/s): how many
HF channels one card serves (divide by 0.048 for 48 kHz channels)."""


def read(run):
    return len(run.rounds) * run.channels * run.chunk / run.window_s / 1e6
