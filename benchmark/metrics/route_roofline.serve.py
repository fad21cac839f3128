"""The multi-source routes' bytes at the memory's rate over the device time of torch.cat's CatArrayBatchedCopy kernels in the traced stretch (%)."""

from benchmark import roofline_route


def read(run):
    return roofline_route.route_roofline_pct(run)
