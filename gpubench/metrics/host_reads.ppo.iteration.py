"""Copies between host and card a training iteration that the host waits
on: the program's ``host_reads`` counts inside the traced window's whole
``ppo.iteration`` spans, over their number (``harness/program_spans.py``).
The program counts them where they happen: the iteration's read of its
losses and stats, and each host number the reset draw copies to the card.
A copy hoisted out of the loop leaves the count."""

from gpubench.harness.program_spans import TRAIN, count


def read(ctx):
    return count(ctx, TRAIN, 'host_reads')
