"""The card's idle ms a traced request while the host is in a per-request build (any `bcnn.build.*`)."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, "build")
