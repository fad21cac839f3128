"""Process start to the first timed request, host clock (s)."""


def read(run):
    return run.setup_s
