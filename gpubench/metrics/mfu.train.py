"""The whole training iteration's share of the float32 peak: the counted
FLOPs of the window's whole iterations (rollout forwards of actor and
critic, the update's forward and backward, Adam, the physics), over the
traced window's length."""

from gpubench.harness.layer import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
