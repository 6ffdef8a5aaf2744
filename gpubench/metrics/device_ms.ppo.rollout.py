"""Card milliseconds a training iteration in the kernels launched while the
host was in ``ppo.rollout``'s own time (the policy side of the rollout:
the observation normalizer, the actor and critic forwards, the sample and
log-prob, the return normalizer, the per-step stores): the traced window's whole
``ppo.iteration`` spans, each kernel put down by its place in its
iteration to the innermost program span open at its launch
(``harness/program_spans.py``). The five ``device_ms.*`` hold nearly all
the iterations' kernel time, the split a fusion is judged by."""

from gpubench.harness.program_spans import TRAIN, device_ms


def read(ctx):
    return device_ms(ctx, TRAIN, 'ppo.rollout')
