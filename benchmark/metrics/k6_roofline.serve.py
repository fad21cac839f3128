"""The batch-norm convs' bytes at the memory's rate over K6's (bn_act_kernel) device time in the traced stretch (%)."""

from benchmark import roofline_k6


def read(run):
    return roofline_k6.k6_roofline_pct(run)
