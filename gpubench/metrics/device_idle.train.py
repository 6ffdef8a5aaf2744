"""The share of the traced window in which the device ran nothing."""

from gpubench.harness.layer import idle_pct


def read(ctx):
    return idle_pct(ctx)
