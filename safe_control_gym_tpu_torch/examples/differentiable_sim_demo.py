"""Differentiable simulation: an open-loop force sequence optimized by the
gradient through the physics.

Port of ``examples/differentiable_sim_demo.py``. ``torch.autograd`` takes the
gradient of the quadratic tracking cost through T steps of ``env.func.step``
(on the card, K1 forward and its plain twin's backward, ``_PlainGrad``), and
``math/optim.py``'s Adam (optax's) descends it, swinging the cartpole from
0.4 rad toward upright. ``main`` returns the cost before and after:

    python -m safe_control_gym_tpu_torch.examples.differentiable_sim_demo [T] [iters] \\
        [--device cpu]
"""

import sys
import time

import torch

from safe_control_gym_tpu_torch.examples import demo_argv, synchronize
from safe_control_gym_tpu_torch.math.optim import adam_init, adam_step
from safe_control_gym_tpu_torch.utils.registration import make


def build(T=60, device='cuda'):
    """The env and ``cost_and_grad(actions (T, 1)) -> (cost, d cost / d actions)``."""
    env = make('cartpole', device=device, seed=0, ctrl_freq=15, pyb_freq=750,
               init_state={'init_theta': 0.4}, randomized_init=False, cost='quadratic')
    func = env.func
    w = torch.tensor([1.0, 0.1, 5.0, 0.1], device=env.device)

    def cost_and_grad(actions):
        a = actions.detach().requires_grad_(True)
        est, _ = func.reset(env.generator)
        cost = torch.zeros((), device=env.device)
        for t in range(T):
            est, _ = func.step(est, a[t][None])
            x = est.state[0]
            cost = cost + torch.sum(w * x * x) + 0.001 * torch.sum(a[t] * a[t])
        cost.backward()
        return cost.detach(), a.grad

    return env, cost_and_grad


def main(T=60, iters=500, device='cuda'):
    env, cost_and_grad = build(T, device)
    actions = torch.zeros((T, 1), device=env.device)
    opt_state = adam_init([actions])
    c0, _ = cost_and_grad(actions)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        _, g = cost_and_grad(actions)
        (actions,), opt_state = adam_step([actions], [g], opt_state, lr=0.1)
    c = float(cost_and_grad(actions)[0])
    dt = time.perf_counter() - t0
    print(f'open-loop cost: {float(c0):.2f} -> {c:.2f} '
          f'({iters} gradient-through-physics steps in {dt:.1f}s)')
    env.close()
    return float(c0), c


if __name__ == '__main__':
    args, dev = demo_argv(sys.argv[1:])
    main(int(args[0]) if args else 60, int(args[1]) if len(args) > 1 else 500, device=dev)
