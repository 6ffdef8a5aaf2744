"""Env steps collected and trained on a second in the traced window: N x T
for each whole ``PPO.learn`` iteration of the window, over its wall time.
The host launches every kernel of the loop, so the host's pace, and the
profiler's cost to it, set this rate; it is what a captured loop would
raise."""


def read(ctx):
    stats = ctx.get('stats') or {}
    if ctx.get('trace') is None or not stats.get('wall_s') or not stats.get('work'):
        return None
    return stats['work'] / stats['wall_s']
