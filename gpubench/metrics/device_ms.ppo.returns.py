"""Card milliseconds a training iteration in the kernels launched while the
host was in ``ppo.returns`` (stacking the rollout, GAE, the advantages'
normalization, the batch's reshape and the stats): the traced window's whole
``ppo.iteration`` spans, each kernel put down by its place in its
iteration to the innermost program span open at its launch
(``harness/program_spans.py``). The five ``device_ms.*`` hold nearly all
the iterations' kernel time, the split a fusion is judged by."""

from gpubench.harness.program_spans import TRAIN, device_ms


def read(ctx):
    return device_ms(ctx, TRAIN, 'ppo.returns')
