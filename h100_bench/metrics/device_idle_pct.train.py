"""The share of a train step in which the device ran nothing: its busy time
per traced step, from the device trace, against the mean step of the run's
window, by the host's clock (``readers.idle_pct``)."""

import readers


def read(ctx):
    return readers.idle_pct(ctx)
