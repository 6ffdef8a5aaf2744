"""Batched MPC: B receding-horizon problems from B states in one solve.

Port of ``examples/mpc/batched_mpc_demo.py``: the SQP (3 iterations of the
batched ADMM QP, ``ops/qp.py``) of B cold-started cartpole problems at once on
the card. ``main`` returns the first inputs and the residuals:

    python -m safe_control_gym_tpu_torch.examples.mpc.batched_mpc_demo [B] [--device cpu]
"""

import sys
import time
from functools import partial

import numpy as np
import torch

from safe_control_gym_tpu_torch.examples import demo_argv, synchronize
from safe_control_gym_tpu_torch.utils.registration import make


def build_batched_solver(horizon=20, device='cuda'):
    """The controller and ``solve(x0s (B, 4)) -> (u0 (B, nu), residual (B,))``,
    tensors, goal the origin."""
    env_func = partial(
        make, 'cartpole', device=device, seed=0, cost='quadratic', ctrl_freq=15, pyb_freq=750,
        constraints=[{'constraint_form': 'default_constraint', 'constrained_variable': 'input'}],
        task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.01},
        randomized_init=False)
    ctrl = make('mpc', env_func, q_mpc=[1], r_mpc=[0.1], horizon=horizon, sqp_iters=3)
    ctrl.reset()
    T, nx = ctrl.T, ctrl.model.nx

    def solve(x0s):
        x0 = torch.as_tensor(x0s, dtype=torch.float32, device=ctrl.device)
        goal = torch.zeros((x0.shape[0], T + 1, nx), device=ctrl.device)
        X, U, _, _, res = ctrl._solve(x0, goal, *ctrl._cold_start(x0),
                                      *ctrl._tightening(x0.shape[0]), None)
        return U[:, 0], res

    return ctrl, solve


def main(argv=None):
    """``argv`` (default ``sys.argv[1:]``): ``[B] [--device DEV]``."""
    args, device = demo_argv(sys.argv[1:] if argv is None else argv)
    B = int(args[0]) if args else 256
    ctrl, solve = build_batched_solver(device=device)
    x0s = np.random.default_rng(0).uniform(-0.3, 0.3, (B, 4)).astype(np.float32)
    solve(x0s)
    synchronize(device)
    t0 = time.perf_counter()
    u0, res = solve(x0s)
    synchronize(device)
    dt = time.perf_counter() - t0
    res_np = res.cpu().numpy()
    print(f'{B} MPC solves (h={ctrl.T}, 3 SQP x 250 ADMM) in {dt*1000:.1f}ms '
          f'-> {B/dt:.0f} solves/s, median residual {float(np.median(res_np)):.2e}, '
          f'{int((res_np < 1e-2).sum())}/{B} converged')
    return u0.cpu().numpy(), res_np


if __name__ == '__main__':
    main()
