"""The share of a sampling pass in which the device ran nothing: its busy time
per traced pass, from the device trace, against the mean pass of the run's
window, by the host's clock (``readers.idle_pct``)."""

import readers


def read(ctx):
    return readers.idle_pct(ctx)
