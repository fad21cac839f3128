"""Host ms a traced request inside the executor's pass (`bcnn.execute`), end to end."""

from benchmark import spans


def read(run):
    return spans.execute_host_ms(run)
