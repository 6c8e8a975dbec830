"""The window's time over its training steps, ms (host clock, ended by a device
synchronisation)."""


def read(run):
    return run.window.seconds / run.window.units * 1e3
