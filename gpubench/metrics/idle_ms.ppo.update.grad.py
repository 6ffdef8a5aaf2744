"""Milliseconds a training iteration in which the card ran no kernel while the
host was in ``ppo.update.grad``'s own time (each minibatch's row gather, both
losses and both gradients): the traced window's whole ``ppo.iteration`` spans,
each moment put down to the innermost program span
(``harness/program_spans.py``). With ``device_ms`` of the same span, the
span's wall time."""

from gpubench.harness.program_spans import TRAIN, idle_ms


def read(ctx):
    return idle_ms(ctx, TRAIN, 'ppo.update.grad')
