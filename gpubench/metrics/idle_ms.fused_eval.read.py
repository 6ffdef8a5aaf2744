"""Milliseconds an ``evaluate_policy_fused`` call in which the card ran no
kernel while the host was in ``fused_eval.read`` (the per-env reads and the
synchronizations around the timed launch): the traced window's whole
``fused_eval`` spans, each moment put down to the innermost program span
(``harness/program_spans.py``)."""

from gpubench.harness.program_spans import EVAL, idle_ms


def read(ctx):
    return idle_ms(ctx, EVAL, 'fused_eval.read')
