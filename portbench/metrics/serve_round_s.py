"""The completed serving rounds' total time over their count, s (host clock)."""


def read(run):
    return run.window.seconds / run.window.units
