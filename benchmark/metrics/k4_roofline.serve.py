"""Sum of the int8 convs' bounds over K4's (conv_int8_kernel) device time in the traced stretch (%)."""

from benchmark import readers


def read(run):
    return readers.k4_roofline_pct(run)
