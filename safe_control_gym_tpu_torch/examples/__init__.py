"""The example entry points of ``examples/`` on the port.

Each script of the repository's ``examples/`` tree has its counterpart here,
at the same place under this package, with the same ``run(...)`` or
``main(...)`` and the same return value. The scripts read their configs
with the port's ``ConfigFactory`` from the repository's YAML, pass
``config.device`` (``'cuda'`` unless ``--device cpu`` is given) to every
``make``, and load the committed models from ``examples/<dir>/`` unless told
another path:

    python -m safe_control_gym_tpu_torch.examples.lqr.lqr_experiment --algo lqr \\
        --task cartpole --overrides examples/lqr/config_overrides/cartpole/cartpole_stab.yaml \\
        examples/lqr/config_overrides/cartpole/lqr_cartpole_stab.yaml
    python -m safe_control_gym_tpu_torch.examples.rl.fused_eval_demo 4096 2048
"""

import os

__all__ = ['EXAMPLES_DIR', 'example_dir', 'print_final_metrics', 'demo_argv', 'synchronize']

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'examples')


def example_dir(*parts) -> str:
    """A path under the repository's ``examples/`` tree."""
    return os.path.join(EXAMPLES_DIR, *parts)


def print_final_metrics(metrics):
    print('FINAL METRICS - ' + ', '.join(f'{key}: {value}' for key, value in metrics.items()))


def demo_argv(argv):
    """A demo's positional arguments and its ``--device`` (default
    ``'cuda'``), from ``argv`` (``sys.argv[1:]``)."""
    argv = list(argv)
    device = 'cuda'
    if '--device' in argv:
        i = argv.index('--device')
        device = argv[i + 1]
        del argv[i:i + 2]
    return argv, device


def synchronize(device):
    """Wait for the card's queue where ``device`` is a CUDA device (before a
    host clock reads a time)."""
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
