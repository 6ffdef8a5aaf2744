"""Device milliseconds a training iteration: the seconds in which the card
ran any work over the whole window (its device activity traced in pieces,
``harness.tracing.DeviceBusy``), over the window's whole iterations.

This is the card time that training costs, whatever the host's pace: what
a user pays where several trainings share one card, as seeds and
hyperparameter sweeps do. An end-to-end metric, so it is read in ``--trace
0`` runs."""

# run.py traces the whole window's device activity for this reader.
WINDOW_TRACE = 'device'


def read(ctx):
    busy = ctx.get('device_busy_s')
    n = (ctx.get('counts') or {}).get('iterations')
    if not busy or not n:
        return None
    return 1e3 * busy / n
