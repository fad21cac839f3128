"""Share of the traced stretch with no kernel, copy or fill on the card (%)."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
