"""Conv operations of the traced requests over the stretch at the precision's peak (%)."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run)
