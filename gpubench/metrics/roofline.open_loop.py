"""K4's or K5's open-loop share of its roofline: the launches' counted
operations and bytes (``counts/rollout.py``) at the published peaks, over
the kernel's device time in the trace."""

from gpubench.harness.layer import roofline_pct


def read(ctx):
    return roofline_pct(ctx)
