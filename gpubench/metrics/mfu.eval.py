"""The whole closed-loop evaluation's share of the float32 peak: the counted
operations of every control step the window's calls ran (the actor and the
env step), over the traced window's length."""

from gpubench.harness.layer import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
