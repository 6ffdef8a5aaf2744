"""Device milliseconds an update, from the controller's own CUDA events
(``PPO.train_seconds['update']``) over the window's iterations."""


def read(ctx):
    c = ctx.get('counts') or {}
    if not c.get('iterations') or c.get('update_s') is None:
        return None
    return 1e3 * c['update_s'] / c['iterations']
