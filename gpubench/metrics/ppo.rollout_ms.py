"""Device milliseconds a rollout, from the controller's own CUDA events
(``PPO.train_seconds['rollout']``) over the window's iterations."""


def read(ctx):
    c = ctx.get('counts') or {}
    if not c.get('iterations') or c.get('rollout_s') is None:
        return None
    return 1e3 * c['rollout_s'] / c['iterations']
