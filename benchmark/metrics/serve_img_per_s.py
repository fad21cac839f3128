"""Images whose detections reached the host in the window, over the window (closed loop: until the last request ends)."""

from benchmark import readers


def read(run):
    return readers.images_per_s(run)
