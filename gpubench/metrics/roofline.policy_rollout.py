"""K4's policy-mode share of its roofline: the launches' counted operations
(the open loop's and the actor's, ``counts/rollout.py``) and bytes at the
published peaks, over the kernel's device time in the trace."""

from gpubench.harness.layer import roofline_pct


def read(ctx):
    return roofline_pct(ctx)
