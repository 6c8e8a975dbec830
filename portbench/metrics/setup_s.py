"""Process start to the first timed unit: building, loading, warming up, and
the checked first steps (host clock)."""


def read(run):
    return run.window.setup_s
