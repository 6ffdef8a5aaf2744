"""Scenario (domain-randomized) robust NMPC: one batched solve a step.

Port of ``examples/mpc/scenario_mpc_demo.py``. ``MPC.select_action_scenarios``
solves the same receding-horizon problem under B sampled parameter sets of
the dynamics as one batch (the parametric hook ``dynamics_func_param`` takes
the scenario's parameters, a dict of (B,) leaves), and a multiple-model
adaptive rule applies the action of the scenario whose dynamics best explain
the observed transitions.

The demo: cartpole stabilization where the true pole (0.9 m effective
length) is much longer than the nominal prior (0.5 m). ``run`` returns the
nominal-prior MPC's mean stage cost, the adaptive scenario MPC's, and the
identified pole length:

    python -m safe_control_gym_tpu_torch.examples.mpc.scenario_mpc_demo [--n_scenarios 16] \\
        [--device cpu]
"""

import argparse
import time
from functools import partial

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.mpc.mpc import MPC
from safe_control_gym_tpu_torch.envs.dynamics import (CartPoleParams, cartpole_dynamics,
                                                      rk4_step)
from safe_control_gym_tpu_torch.utils.registration import make

TRUE_LENGTH = 0.9          # effective (half) pole length of the real plant
NOMINAL_LENGTH = 0.5       # what the nominal prior believes

TASK = dict(seed=42, cost='quadratic', ctrl_freq=15, pyb_freq=750,
            episode_len_sec=6, randomized_init=False,
            init_state={'init_theta': 0.15},
            task_info={'stabilization_goal': [0.0],
                       'stabilization_goal_tolerance': 0.0},
            inertial_prop={'pole_length': TRUE_LENGTH},
            done_on_out_of_bound=False,
            constraints=[{'constraint_form': 'default_constraint',
                          'constrained_variable': 'input'}])

# A DARE terminal cost: without it a 1 s horizon is myopic about the slow
# long-pole plant's x drift for every prior.
MPC_KW = dict(q_mpc=[5, 0.1, 5, 0.1], r_mpc=[0.1], horizon=15, warmstart=True, sqp_iters=2,
              use_lqr_gain_and_terminal_cost=True)


class ScenarioCartpoleMPC(MPC):
    """MPC whose prior dynamics take a scenario's cartpole parameters."""

    def dynamics_func_param(self, x, u, p):
        return rk4_step(cartpole_dynamics, x, u, self.dt, CartPoleParams(**p))


def sample_scenarios(n, low=0.4, high=1.0, seed=0):
    """``n`` pole lengths uniform in [low, high), the first the nominal one;
    a dict of float32 (n,) arrays."""
    lengths = np.random.default_rng(seed).uniform(low, high, n)
    lengths[0] = NOMINAL_LENGTH
    full = lambda v: np.full((n,), v, np.float32)
    return {'pole_length': lengths.astype(np.float32), 'pole_mass': full(0.1),
            'cart_mass': full(1.0), 'gravity': full(9.8)}


class AdaptiveScenarioPolicy:
    """Multiple-model adaptive control over the scenarios: apply the action
    of the scenario whose one-step predictions best explain the observed
    transitions (errors discounted by ``forget``)."""

    def __init__(self, ctrl, scenarios, n, forget=0.9):
        self.ctrl, self.scenarios, self.n = ctrl, scenarios, n
        self.forget = forget
        self.err = np.zeros(n)
        self.prev = None          # (x, u) of the last applied transition
        self._params = CartPoleParams(**{k: torch.as_tensor(v) for k, v in scenarios.items()})

    def __call__(self, obs):
        x = np.asarray(obs, np.float32)[:self.ctrl.model.nx]
        if self.prev is not None:
            xp, up = self.prev
            preds = rk4_step(cartpole_dynamics, torch.as_tensor(xp).expand(self.n, -1),
                             torch.as_tensor(up).expand(self.n, -1), self.ctrl.dt,
                             self._params).numpy()
            self.err = self.forget * self.err + np.linalg.norm(preds - x[None], axis=1)
        cands, feas = self.ctrl.select_action_scenarios(x, self.scenarios)
        u = cands[int(np.argmin(np.where(feas, self.err, np.inf)))]
        self.prev = (x, np.atleast_1d(np.asarray(u, np.float32)))
        return u

    @property
    def identified_length(self):
        return float(self.scenarios['pole_length'][int(np.argmin(self.err))])


def run_episode(env_func, action_fn):
    """One episode of ``action_fn(obs)``; its mean stage cost."""
    env = env_func()
    obs, _ = env.reset()
    done, costs = False, []
    while not done:
        obs, rew, done, info = env.step(action_fn(obs))
        costs.append(-rew)
    env.close()
    return float(np.mean(costs))


def run(n_scenarios=16, verbose=True, device='cuda'):
    env_func = partial(make, 'cartpole', device=device, **TASK)
    prior = {'prior_prop': {'pole_length': NOMINAL_LENGTH}}
    nominal = make('mpc', env_func, prior_info=prior, **MPC_KW)
    nominal.reset()
    cost_nom = run_episode(env_func, lambda o: nominal.select_action(o, None))
    nominal.close()

    ctrl = ScenarioCartpoleMPC(env_func, prior_info=prior, **MPC_KW)
    ctrl.reset()
    policy = AdaptiveScenarioPolicy(ctrl, sample_scenarios(n_scenarios), n_scenarios)
    t0 = time.perf_counter()
    cost_scen = run_episode(env_func, policy)
    dt = time.perf_counter() - t0
    ctrl.close()

    if verbose:
        print(f'true pole length {TRUE_LENGTH} m, nominal prior '
              f'{NOMINAL_LENGTH} m, {n_scenarios} scenarios')
        print(f'nominal-prior MPC        mean stage cost: {cost_nom:.4f}')
        print(f'adaptive scenario MPC    mean stage cost: {cost_scen:.4f} '
              f'({dt:.1f} s closed loop)')
        print(f'identified pole length: {policy.identified_length:.3f} m '
              f'(true {TRUE_LENGTH})')
        print(f'improvement: {cost_nom / cost_scen:.2f}x')
    return cost_nom, cost_scen, policy.identified_length


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--n_scenarios', type=int, default=16)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    run(n_scenarios=args.n_scenarios, device=args.device)
