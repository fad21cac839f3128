"""Kernels the card ran a traced request."""

from benchmark import readers


def read(run):
    return readers.kernels_per_request(run)
