"""Population PPO: P hyperparameter draws trained side by side as one batch on the device.

Port of ``safe_control_gym_tpu/hyperparameters/population.py``. The JAX
package vmaps a whole training run over the population. The port cannot:
its physics kernels (K1-K3, ``ops/physics_kernels.py``) launch through
ctypes on ``data_ptr()``, which a ``torch.func.vmap`` batched tensor does not
have, and the plain versions write in place. So the population axis is
explicit:

* every actor and critic weight is stacked as (P, ...), and the MLPs run as
  ``torch.baddbmm`` over the lanes;
* the P lanes' N envs are one ``EnvState`` of P×N rows (lane-major), so a
  rollout step is one ``step_autoreset`` for the whole population: one K1,
  K2 or K3 launch on the card, whatever P is;
* the evaluation is one ``func.step`` a step over P×n_eval envs, with a
  per-lane alive mask;
* each hyperparameter of ``VECTOR_HPS`` is a (P,) tensor, broadcast as
  (P, 1, 1): learning rates, entropy coefficient, target KL, clip, gamma,
  GAE lambda and the gradient-norm bound;
* Adam with a per-lane global-norm clip in ``torch._foreach`` ops over the
  stacked leaves, and the KL gate as a per-lane ``torch.where``: no host read
  a step.

Every lane runs the PPO of the JAX package's evaluator: T steps of N envs
with auto-reset, GAE, ``opt_epochs`` epochs of KL-gated minibatch steps on
the lane's own permutations, for ``iterations`` iterations; then
``n_eval`` deterministic episodes of the mode action.

Randomness: lane p draws everything from its own ``torch.Generator`` seeded
with ``seeds[p]`` (its initial parameters, initial states, action normals,
reset states, permutations, evaluation states, in that order), so a lane's
result does not depend on the others. ``evaluate(..., draws=...)`` takes
these draws from the caller instead (``lane_draws`` gives them in the form
``evaluate`` takes), so that another implementation's draws can be fed in.

With ``mesh`` (``parallel/sharding.py``), the P lanes split over the ranks of
``axis_name``: rank r trains lanes ``[r P/W, (r+1) P/W)`` (one K1 launch a
step for its (P/W)×N envs on the card) and every rank returns the (P,
n_eval) returns, gathered. Lanes are independent, so a lane's result is the
one-process run's.

    ev = make_population_ppo_evaluator(partial(make, 'cartpole'), rollout_batch_size=16,
                                       rollout_steps=100, iterations=2, device='cuda')
    returns = ev({'actor_lr': np.array([3e-4, 1e-3])}, seeds=[0, 1])   # (2, n_eval)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import (
    compute_returns_and_advantages, init_actor_critic)
from safe_control_gym_tpu_torch.envs.benchmark_env import EnvState
from safe_control_gym_tpu_torch.math.distributions import Normal
from safe_control_gym_tpu_torch.math.networks import ACTIVATIONS
from safe_control_gym_tpu_torch.math.optim import tree_leaves, tree_unflatten
from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['VECTOR_HPS', 'STRUCTURAL_HPS', 'DEFAULTS', 'split_suggestion', 'adam_init',
           'adam_step', 'stacked_mlp', 'PopulationPPO', 'make_population_ppo_evaluator']

# Hyperparameters that may differ lane by lane.
VECTOR_HPS = ('actor_lr', 'critic_lr', 'entropy_coef', 'target_kl', 'clip_param', 'gamma',
              'gae_lambda', 'max_grad_norm')
# Hyperparameters that shape the program, shared by a population.
STRUCTURAL_HPS = ('hidden_dim', 'activation', 'opt_epochs', 'mini_batch_size',
                  'rollout_steps', 'rollout_batch_size', 'max_env_steps')
# PPO's registry defaults for a lane the caller gives no value.
DEFAULTS = {'actor_lr': 3e-4, 'critic_lr': 1e-3, 'entropy_coef': 0.01, 'target_kl': 0.01,
            'clip_param': 0.2, 'gamma': 0.99, 'gae_lambda': 0.95, 'max_grad_norm': 0.5}

B1, B2, EPS = 0.9, 0.999, 1e-8


def split_suggestion(suggestion: dict):
    """A sampler's suggestion as ``(vector, structural)`` dicts."""
    vec = {k: float(v) for k, v in suggestion.items() if k in VECTOR_HPS}
    struct = {k: v for k, v in suggestion.items() if k not in VECTOR_HPS}
    return vec, struct


def _lanes(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (P,) tensor viewed to broadcast against ``like`` (P, ...)."""
    return x.view((x.shape[0],) + (1,) * (like.dim() - 1))


# -- Adam over stacked leaves, the lanes' own learning rates and clip --------
# The JAX evaluator's rule (b1, b2, eps as optax's; the clip scales by
# min(1, max_norm / sqrt(sum g^2 + 1e-24)), lane by lane).

def adam_init(leaves: List[torch.Tensor]) -> Dict:
    return {'m': [torch.zeros_like(p) for p in leaves],
            'v': [torch.zeros_like(p) for p in leaves],
            't': torch.zeros(leaves[0].shape[0], device=leaves[0].device)}


def adam_step(grads, state, params, lr, max_grad_norm):
    """One clipped Adam step of every lane: ``(new_params, new_state)``.
    ``lr`` and ``max_grad_norm`` are (P,) tensors."""
    p_lanes = params[0].shape[0]
    sq = torch._foreach_mul(grads, grads)
    total = 0
    for s in sq:
        total = total + s.reshape(p_lanes, -1).sum(1)
    gnorm = torch.sqrt(total + 1e-24)
    scale = torch.minimum(torch.ones_like(gnorm), max_grad_norm / gnorm)
    grads = torch._foreach_mul(grads, [_lanes(scale, g) for g in grads])
    t = state['t'] + 1.0
    m = torch._foreach_mul(state['m'], B1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1 - B1))
    v = torch._foreach_mul(state['v'], B2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, 1 - B2), grads))
    bc1 = 1.0 - torch.pow(B1, t)
    bc2 = 1.0 - torch.pow(B2, t)
    step = torch._foreach_div(m, [_lanes(bc1, p) for p in params])
    torch._foreach_mul_(step, [_lanes(lr, p) for p in params])
    denom = torch._foreach_div(v, [_lanes(bc2, p) for p in params])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    torch._foreach_div_(step, denom)
    return list(torch._foreach_sub(params, step)), {'m': list(m), 'v': list(v), 't': t}


def _select(gate, new, old):
    """Lane by lane, ``new`` where ``gate`` (P,) else ``old``, over lists or
    optimizer states."""
    if isinstance(new, dict):
        return {k: _select(gate, new[k], old[k]) for k in new}
    if isinstance(new, list):
        return [torch.where(_lanes(gate, n), n, o) for n, o in zip(new, old)]
    return torch.where(gate, new, old)


def stacked_mlp(layers, x, activation='tanh'):
    """The MLP of every lane: ``x`` (P, M, in) through layers of ``w`` (P, in,
    out) and ``b`` (P, out)."""
    act = ACTIVATIONS[activation]
    h = x
    for layer in layers[:-1]:
        h = act(torch.baddbmm(layer['b'][:, None, :], h, layer['w']))
    return torch.baddbmm(layers[-1]['b'][:, None, :], h, layers[-1]['w'])


def _dist(params, obs, activation):
    return Normal(stacked_mlp(params['actor'], obs, activation),
                  torch.exp(params['logstd'])[:, None, :])


# -- EnvState rows -------------------------------------------------------

def _batched_params(params) -> List[str]:
    """The per-env (batched) fields of an inertial-parameter set; the 0-d
    ones are shared by the batch."""
    return [f.name for f in dataclasses.fields(params) if getattr(params, f.name).ndim]


def _map_state(est: EnvState, fn) -> EnvState:
    """``fn`` over every batched field, per-env inertial parameters included."""
    params = est.dyn_params
    params = dataclasses.replace(params, **{k: fn(getattr(params, k))
                                            for k in _batched_params(params)})
    return est.replace(dyn_params=params, **{
        f.name: fn(getattr(est, f.name)) for f in dataclasses.fields(est)
        if f.name != 'dyn_params'})


def _cat_states(states: List[EnvState], dim=0) -> EnvState:
    first = states[0]
    params = [s.dyn_params for s in states]
    return first.replace(
        dyn_params=dataclasses.replace(first.dyn_params, **{
            k: torch.cat([getattr(p, k) for p in params], dim)
            for k in _batched_params(first.dyn_params)}),
        **{f.name: torch.cat([getattr(s, f.name) for s in states], dim)
           for f in dataclasses.fields(first) if f.name != 'dyn_params'})


def per_step(est: EnvState, obs: torch.Tensor, steps: int):
    """Draws of ``steps * B`` rows, step-major, as fields of (steps, B, ...)."""
    split = lambda t: t.reshape((steps, t.shape[0] // steps) + tuple(t.shape[1:]))
    return _map_state(est, split), split(obs)


class _LaneDraws:
    """Each lane's draws from its own generator, made as the run asks for them."""

    def __init__(self, pop: 'PopulationPPO', seeds):
        self.pop = pop
        self.gens = [torch.Generator(device=pop.device).manual_seed(int(s)) for s in seeds]

    def params(self):
        pop = self.pop
        trees = [init_actor_critic(g, pop.obs_dim, pop.act_dim, [pop.hidden_dim] * 2)
                 for g in self.gens]
        return tree_unflatten(trees[0], [torch.stack(ls) for ls in
                                         zip(*[tree_leaves(t) for t in trees])])

    def _resets(self, n):
        ests, obs = zip(*[self.pop.func.reset_batch(g, n) for g in self.gens])
        return _cat_states(list(ests)), torch.cat(obs)

    def init(self):
        return self._resets(self.pop.N)

    def iteration(self, it):
        pop = self.pop
        T, N = pop.T, pop.N
        noise = torch.stack([torch.randn((T, N, pop.act_dim), generator=g, device=pop.device)
                             for g in self.gens], 1)
        fresh = [per_step(*pop.func.reset_batch(g, T * N), T) for g in self.gens]
        fresh = (_cat_states([f[0] for f in fresh], 1), torch.cat([f[1] for f in fresh], 1))
        perms = torch.stack([torch.stack([
            torch.randperm(pop.M, generator=g, device=pop.device)[:pop.used]
            for _ in range(pop.opt_epochs)]) for g in self.gens], 1)
        return {'act_noise': noise, 'fresh': fresh, 'perms': perms}

    def eval(self):
        return self._resets(self.pop.n_eval)

    def channel_noise(self, n):
        """Each stochastic disturbance channel's noise of one step, ``n`` rows
        a lane."""
        return {ch: torch.cat([dl.draw(g, n) for g in self.gens])
                for ch, dl in self.pop.stochastic.items()}


class _FedDraws:
    """Draws given by the caller (``lane_draws``'s form)."""

    def __init__(self, draws):
        self.d = draws

    def params(self):
        return self.d['params']

    def init(self):
        return self.d['init']

    def iteration(self, it):
        return self.d['iterations'][it]

    def eval(self):
        return self.d['eval']


class PopulationPPO:
    """The population's PPO: ``evaluate(hp_arrays, seeds)`` trains and evaluates
    P lanes and returns their (P, n_eval) episode returns. Also callable."""

    def __init__(self, env_func, rollout_batch_size=32, rollout_steps=64, iterations=20,
                 opt_epochs=10, mini_batch_size=64, hidden_dim=64, activation='tanh',
                 use_gae=True, n_eval=5, device='cuda', mesh=None, axis_name='pop'):
        self.device = resolve_device(device)
        if mesh is not None:
            mesh.check_device(self.device)
        self.mesh, self.axis_name = mesh, axis_name
        self.env = env_func(device=self.device)
        self.func = self.env.func
        self.obs_dim = self.env.observation_space.shape[0]
        self.act_dim = self.env.action_space.shape[0]
        self.stochastic = {ch: dl for ch, dl in self.env.disturbances.items()
                           if dl and dl.noise_size > 0}
        self.N, self.T = int(rollout_batch_size), int(rollout_steps)
        self.iterations = int(iterations)
        self.opt_epochs = int(opt_epochs)
        self.hidden_dim = int(hidden_dim)
        self.activation = activation
        self.use_gae = bool(use_gae)
        self.n_eval = int(n_eval)
        self.M = self.T * self.N
        self.mb = min(int(mini_batch_size), self.M)
        self.num_mb = max(self.M // self.mb, 1)
        self.used = self.num_mb * self.mb
        self.eval_steps = int(self.func.max_steps) + 1
        self.env_steps_per_lane = self.N * self.T * self.iterations

    def _channel_noise(self, src, n):
        """A step's disturbance noise, ``n`` rows a lane, from the lanes'
        generators (None without stochastic disturbances; fed draws carry
        none)."""
        if not self.stochastic:
            return None
        if not isinstance(src, _LaneDraws):
            raise ValueError('an env with stochastic disturbances draws its noise from the '
                             "lanes' generators: evaluate it without fed draws")
        return src.channel_noise(n)

    def hp_tensors(self, hp_arrays, p_lanes):
        """Each of ``VECTOR_HPS`` as a (P,) float32 tensor (defaults where missing)."""
        return {k: torch.as_tensor(np.asarray(hp_arrays.get(k, np.full(p_lanes, DEFAULTS[k])),
                                              np.float32).reshape(p_lanes), device=self.device)
                for k in VECTOR_HPS}

    def lane_draws(self, seeds) -> Dict:
        """Every draw ``evaluate(hp, seeds)`` makes, as the dict its ``draws``
        takes: ``params`` (a stacked pytree), ``init`` and ``eval`` (an
        ``EnvState`` and obs of P×N and P×n_eval rows), and for each
        iteration ``act_noise`` (T, P, N, act_dim), ``fresh`` (the reset
        states and obs, fields of (T, P×N, ...)) and ``perms`` (epochs, P,
        rows used)."""
        src = _LaneDraws(self, seeds)
        return {'params': src.params(), 'init': src.init(),
                'iterations': [src.iteration(i) for i in range(self.iterations)],
                'eval': src.eval()}

    def select_lanes(self, draws, lanes) -> Dict:
        """The draws of the lanes ``lanes`` (indices) of a ``lane_draws`` dict,
        in the same form, for a population of ``len(lanes)`` lanes."""
        idx = torch.as_tensor(lanes, device=self.device)
        rows = lambda n: (idx[:, None] * n + torch.arange(n, device=self.device)).reshape(-1)

        def pick(est_obs, n, step_dim=False):
            r = rows(n)
            take = (lambda x: x[:, r]) if step_dim else (lambda x: x[r])
            return _map_state(est_obs[0], take), take(est_obs[1])

        return {'params': tree_unflatten(draws['params'],
                                         [x[idx] for x in tree_leaves(draws['params'])]),
                'init': pick(draws['init'], self.N),
                'iterations': [{'act_noise': it['act_noise'][:, idx],
                                'fresh': pick(it['fresh'], self.N, step_dim=True),
                                'perms': it['perms'][:, idx]} for it in draws['iterations']],
                'eval': pick(draws['eval'], self.n_eval)}

    # -- one iteration -----------------------------------------------------
    @torch.no_grad()
    def rollout(self, params, hp, est, obs, draws_it, src=None):
        """T steps of all P×N envs and the lanes' GAE: ``(est, obs, batch)``
        with ``batch`` of (P, T×N, ...) tensors, rows step-major. ``src``, the
        lanes' own draws, gives the disturbance channels' noise where the env
        has any."""
        P, N, T = hp['gamma'].shape[0], self.N, self.T
        fresh_est, fresh_obs = draws_it['fresh']
        ys = {k: [] for k in ('obs', 'act', 'rew', 'mask', 'v', 'logp', 'term_v')}
        obs = obs.reshape(P, N, -1)
        for t in range(T):
            dist = _dist(params, obs, self.activation)
            act = dist.loc + dist.scale * draws_it['act_noise'][t]
            logp = dist.log_prob(act)
            v = stacked_mlp(params['critic'], obs, self.activation)
            fresh = (_map_state(fresh_est, lambda x: x[t]), fresh_obs[t])
            est, out, next_obs = self.func.step_autoreset(
                est, act.reshape(P * N, -1), None,
                drawn=self._channel_noise(src, N), fresh=fresh)
            term_v = stacked_mlp(params['critic'], out.obs.reshape(P, N, -1), self.activation)
            for k, y in (('obs', obs), ('act', act), ('rew', out.reward.reshape(P, N, 1)),
                         ('mask', 1.0 - out.done.to(torch.float32).reshape(P, N, 1)),
                         ('v', v), ('logp', logp),
                         ('term_v', torch.where(out.truncated.reshape(P, N, 1), term_v,
                                                torch.zeros_like(term_v)))):
                ys[k].append(y)
            obs = next_obs.reshape(P, N, -1)
        ys = {k: torch.stack(v) for k, v in ys.items()}
        last_val = stacked_mlp(params['critic'], obs, self.activation)
        lanes = lambda x: x.view(P, 1, 1)
        rets, advs = compute_returns_and_advantages(
            ys['rew'], ys['v'], ys['mask'], ys['term_v'], last_val, lanes(hp['gamma']),
            self.use_gae, lanes(hp['gae_lambda']))
        flat = lambda x: x.transpose(0, 1).reshape(P, T * N, -1)
        advs = flat(advs)
        # Each lane's statistics over its own contiguous rows.
        mean = advs.mean(dim=(1, 2), keepdim=True)
        std = advs.std(dim=(1, 2), keepdim=True, correction=0)
        batch = {'obs': flat(ys['obs']), 'act': flat(ys['act']), 'logp': flat(ys['logp']),
                 'adv': (advs - mean) / (std + 1e-6), 'ret': flat(rets)}
        return est, obs.reshape(P * N, -1), batch

    def _policy_loss(self, actor, hp, mb):
        dist = _dist(actor, mb['obs'], self.activation)
        logp = dist.log_prob(mb['act'])
        ratio = torch.exp(torch.clamp(logp - mb['logp'], -20.0, 20.0))
        clip = hp['clip_param'].view(-1, 1, 1)
        clip_adv = torch.clamp(ratio, 1 - clip, 1 + clip) * mb['adv']
        policy_loss = -torch.minimum(ratio * mb['adv'], clip_adv).mean(dim=(1, 2))
        entropy_loss = -dist.entropy().mean(dim=(1, 2))
        kl = (mb['logp'] - logp).mean(dim=(1, 2))
        return policy_loss + hp['entropy_coef'] * entropy_loss, kl

    def _value_loss(self, critic, mb):
        v = stacked_mlp(critic, mb['obs'], self.activation)
        return 0.5 * ((v - mb['ret']) ** 2).mean(dim=(1, 2))

    def update(self, params, a_opt, c_opt, hp, batch, perms):
        """``opt_epochs`` epochs of every lane's KL-gated minibatch steps on its
        own permutations ``perms`` (epochs, P, rows used): ``(params, a_opt,
        c_opt)``."""
        P = perms.shape[1]
        lane_idx = torch.arange(P, device=self.device)[:, None]
        actor_like = {k: params[k] for k in ('actor', 'logstd')}
        for epoch in range(perms.shape[0]):
            for i in range(self.num_mb):
                idx = perms[epoch][:, i * self.mb:(i + 1) * self.mb]
                mb = {k: v[lane_idx, idx] for k, v in batch.items()}
                a_old = tree_leaves({k: params[k] for k in ('actor', 'logstd')})
                a_leaves = [p.detach().requires_grad_(True) for p in a_old]
                with torch.enable_grad():
                    loss, kl = self._policy_loss(tree_unflatten(actor_like, a_leaves), hp, mb)
                    a_grads = torch.autograd.grad(loss.sum(), a_leaves)
                a_new, a_opt_new = adam_step(list(a_grads), a_opt, a_old, hp['actor_lr'],
                                             hp['max_grad_norm'])
                gate = (hp['target_kl'] <= 0) | (kl.detach() <= 1.5 * hp['target_kl'])
                a_applied = _select(gate, a_new, a_old)
                a_opt = _select(gate, a_opt_new, a_opt)
                c_old = tree_leaves(params['critic'])
                c_leaves = [p.detach().requires_grad_(True) for p in c_old]
                with torch.enable_grad():
                    v_loss = self._value_loss(tree_unflatten(params['critic'], c_leaves), mb)
                    c_grads = torch.autograd.grad(v_loss.sum(), c_leaves)
                c_new, c_opt = adam_step(list(c_grads), c_opt, c_old, hp['critic_lr'],
                                         hp['max_grad_norm'])
                params = {**tree_unflatten(actor_like, a_applied),
                          'critic': tree_unflatten(params['critic'], c_new)}
        return params, a_opt, c_opt

    # -- the whole run -------------------------------------------------------
    def train(self, hp, src):
        """Train every lane from ``src``'s draws; returns the final params."""
        params = src.params()
        a_opt = adam_init(tree_leaves({k: params[k] for k in ('actor', 'logstd')}))
        c_opt = adam_init(tree_leaves(params['critic']))
        est, obs = src.init()
        for it in range(self.iterations):
            draws_it = src.iteration(it)
            est, obs, batch = self.rollout(params, hp, est, obs, draws_it, src)
            params, a_opt, c_opt = self.update(params, a_opt, c_opt, hp, batch,
                                               draws_it['perms'])
        return params

    @torch.no_grad()
    def evaluate_params(self, params, src, p_lanes):
        """``n_eval`` deterministic episodes of every lane's mode action, one
        ``func.step`` a step for all P×n_eval envs: (P, n_eval) returns."""
        est, obs = src.eval()
        n = p_lanes * self.n_eval
        alive = torch.ones(n, dtype=torch.bool, device=self.device)
        total = torch.zeros(n, device=self.device)
        for _ in range(self.eval_steps):
            act = stacked_mlp(params['actor'], obs.reshape(p_lanes, self.n_eval, -1),
                              self.activation)
            est, out = self.func.step(est, act.reshape(n, -1),
                                      drawn=self._channel_noise(src, self.n_eval))
            total = total + torch.where(alive, out.reward, torch.zeros_like(out.reward))
            alive = alive & ~out.done
            obs = out.obs
        return total.reshape(p_lanes, self.n_eval)

    def evaluate(self, hp_arrays, seeds, draws=None) -> np.ndarray:
        """Train and evaluate one lane for each entry of ``seeds``, lane p with
        the p-th value of each array of ``hp_arrays`` ((P,) arrays keyed by
        ``VECTOR_HPS``; PPO's defaults where a name is missing). ``draws``
        (``lane_draws``'s form) replaces the lanes' own draws. Returns the
        (P, n_eval) episode returns as numpy, the run's one host read. With a
        mesh, this rank trains its lanes (P must divide over the axis) and the
        returns of every lane are gathered."""
        p_lanes = len(seeds)
        hp = self.hp_tensors(hp_arrays, p_lanes)
        if self.mesh is not None:
            lo, hi = self.mesh.rows(p_lanes, self.axis_name)
            hp = {k: v[lo:hi] for k, v in hp.items()}
            seeds = list(seeds)[lo:hi]
            if draws is not None:
                draws = self.select_lanes(draws, list(range(lo, hi)))
            p_lanes = hi - lo
        src = _FedDraws(draws) if draws is not None else _LaneDraws(self, seeds)
        params = self.train(hp, src)
        returns = self.evaluate_params(params, src, p_lanes)
        if self.mesh is not None:
            returns = self.mesh.gather_rows(returns, len(seeds) * self.mesh.shape[self.axis_name],
                                            self.axis_name)
        return returns.cpu().numpy()

    __call__ = evaluate


def make_population_ppo_evaluator(env_func, rollout_batch_size=32, rollout_steps=64,
                                  iterations=20, opt_epochs=10, mini_batch_size=64,
                                  hidden_dim=64, activation='tanh', use_gae=True, n_eval=5,
                                  mesh=None, axis_name='pop', device='cuda') -> PopulationPPO:
    """The population evaluator (the JAX package's factory's signature, with
    ``device``; it runs on the card unless given ``device='cpu'``). ``mesh``
    splits the lanes over the ranks of ``axis_name``."""
    return PopulationPPO(env_func, rollout_batch_size=rollout_batch_size,
                         rollout_steps=rollout_steps, iterations=iterations,
                         opt_epochs=opt_epochs, mini_batch_size=mini_batch_size,
                         hidden_dim=hidden_dim, activation=activation, use_gae=use_gae,
                         n_eval=n_eval, device=device, mesh=mesh, axis_name=axis_name)
