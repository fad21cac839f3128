"""The card's idle ms a traced request while the host is in the port's upload (`bcnn.upload`)."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, "upload")
