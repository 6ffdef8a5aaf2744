"""Batched GP-MPC: B cautious-MPC solves (GP-mean dynamics, chance-constraint
tightening, the SQP) from B states in one batched solve.

Port of ``examples/mpc/batched_gp_mpc_demo.py``. ``main`` returns the first
inputs, the feasibility flags and the counts of capped tightenings:

    python -m safe_control_gym_tpu_torch.examples.mpc.batched_gp_mpc_demo [B] [--device cpu]
"""

import sys
import time
from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.examples import demo_argv, synchronize
from safe_control_gym_tpu_torch.utils.registration import make


def build_controller(horizon=15, device='cuda'):
    """GP-MPC on the constrained cartpole, its residual GP learned from a
    one-shot Latin-hypercube bootstrap."""
    env_func = partial(
        make, 'cartpole', device=device, seed=0, cost='quadratic', ctrl_freq=15, pyb_freq=750,
        constraints=[{'constraint_form': 'default_constraint', 'constrained_variable': 'input'},
                     {'constraint_form': 'default_constraint', 'constrained_variable': 'state'}],
        task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.01},
        randomized_init=False)
    ctrl = make('gp_mpc', env_func, q_mpc=[1], r_mpc=[0.1], horizon=horizon,
                prior_info={'prior_prop': {'pole_length': 1.0}},
                num_samples=60, optimization_iterations=120, seed=0)
    ctrl.reset()
    ctrl.learn()
    return ctrl


def main(argv=None):
    """``argv`` (default ``sys.argv[1:]``): ``[B] [--device DEV]``."""
    args, device = demo_argv(sys.argv[1:] if argv is None else argv)
    B = int(args[0]) if args else 256
    ctrl = build_controller(device=device)
    x0s = np.random.default_rng(0).uniform(-0.3, 0.3, (B, ctrl.model.nx)).astype(np.float32)
    ctrl.select_action_batch(x0s)
    synchronize(device)
    t0 = time.perf_counter()
    u0, feas, binds = ctrl.select_action_batch(x0s)
    dt = time.perf_counter() - t0
    print(f'{B} GP-MPC solves (h={ctrl.T}, 2 tightening passes, '
          f'{ctrl.data_inputs.shape[0]} GP points) in {dt*1000:.1f}ms '
          f'-> {B/dt:.0f} solves/s, {int(feas.sum())}/{B} feasible, '
          f'{int((binds > 0).sum())} with capped tightening')
    return u0, feas, binds


if __name__ == '__main__':
    main()
