"""The card's idle ms a traced request while the host is in the executor's pass (`bcnn.execute`), outside builds."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, "execute")
