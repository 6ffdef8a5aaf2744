"""Batched MPSC certification: B (state, action) pairs certified in one batched solve.

Port of ``examples/mpsc/batched_certification_demo.py``: the tube MPC of the
linear MPSC filter (2 SQP iterations of the batched ADMM QP with its polish,
the terminal-set check) for B problems at once on the card. ``main`` returns
the certified actions and the feasibility flags:

    python -m safe_control_gym_tpu_torch.examples.mpsc.batched_certification_demo [B] \\
        [--device cpu]
"""

import sys
import time
from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.examples import demo_argv, synchronize
from safe_control_gym_tpu_torch.utils.registration import make

TASK = dict(
    seed=42, cost='quadratic', ctrl_freq=15, pyb_freq=750,
    task='stabilization',
    task_info={'stabilization_goal': [0.0],
               'stabilization_goal_tolerance': 0.005},
    init_state={'init_theta': 0.1}, randomized_init=False,
    episode_len_sec=6,
    constraints=[{'constraint_form': 'default_constraint',
                  'constrained_variable': 'state',
                  'upper_bounds': [1.5, 2, 0.3, 2],
                  'lower_bounds': [-1.5, -2, -0.3, -2]},
                 {'constraint_form': 'default_constraint',
                  'constrained_variable': 'input',
                  'upper_bounds': [5], 'lower_bounds': [-5]}],
    done_on_out_of_bound=False)

# No terminal set, as in the committed example configs: the demo shows
# throughput, and the 0.005-ball terminal set makes random states' feasibility
# borderline.
SF = dict(horizon=10, q_lin=[1], r_lin=[1], integration_algo='rk4', n_samples=120, tau=0.95,
          seed=0, use_terminal_set=False)


def build_filter(device='cuda'):
    """The demo's filter, its RPI set learned."""
    sf = make('linear_mpsc', partial(make, 'cartpole', device=device, **TASK), **SF)
    sf.learn()
    return sf


def demo_inputs(B):
    rng = np.random.default_rng(0)
    return (rng.normal(0, 0.3, (B, 4)).astype(np.float32),
            rng.uniform(-4, 4, (B, 1)).astype(np.float32))


def certify(sf, B, device='cuda'):
    """Certify the demo's B pairs (a first call, then the timed one); prints
    the figures and returns the certified actions and flags."""
    states, actions = demo_inputs(B)
    sf.certify_action_batch(states, actions)
    synchronize(device)
    t0 = time.perf_counter()
    certified, feasible = sf.certify_action_batch(states, actions)
    dt = time.perf_counter() - t0
    corr = np.linalg.norm(certified - actions, axis=1)
    print(f'{B} certifications in {dt*1000:.0f}ms -> {B/dt:.0f}/s, '
          f'{int(feasible.sum())}/{B} feasible, mean correction {float(corr.mean()):.3f}')
    return certified, feasible


def main(argv=None):
    """``argv`` (default ``sys.argv[1:]``): ``[B] [--device DEV]``."""
    args, device = demo_argv(sys.argv[1:] if argv is None else argv)
    B = int(args[0]) if args else 256
    sf = build_filter(device)
    out = certify(sf, B, device)
    sf.close()
    return out


if __name__ == '__main__':
    main()
