"""Host-to-device copy time on the card a traced request (ms)."""

from benchmark import readers


def read(run):
    return readers.upload_ms(run)
