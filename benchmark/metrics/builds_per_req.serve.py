"""Per-request builds (`bcnn.build.*` spans) a traced request."""

from benchmark import spans


def read(run):
    return spans.builds_per_request(run)
