"""The plain reference of PPO training on the 3D quadrotor.

A frozen, self-contained copy of what one training iteration computes, in the
program's order of operations: the N envs' T steps (the Gaussian policy's
draw, the normalized action's denormalization, the clip, the motor model
cmd -> PWM -> RPM -> forces, the 20 physics substeps, the RL reward, done on
bounds and time limit, the truncation bootstrap, auto-reset to randomized
start states), the returns and GAE advantages and their normalization, then
the epochs of minibatch updates (clipped surrogate, entropy, value loss,
autograd, the global-norm clip, Adam, the KL gate that rejects a whole actor
step). Every random draw comes from a generator seeded as the program's is,
in the program's order, so the reference follows the program step for step.

Only the configuration's path is written out: stabilization with the RL
reward, no constraints, disturbances or normalizers (the configuration's
``norm_obs`` and ``norm_reward`` are off). Run with
``torch.backends.cuda.matmul.allow_tf32`` on, it is the lower-precision
control (``gpubench/controls.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from gpubench.reference import envcfg
from gpubench.reference.rollout import _SQRT2_F32, quad3d_substeps

_LOG_2PI = math.log(2.0 * math.pi)
B1, B2, EPS = 0.9, 0.999, 1e-8
_OOB_MASK = [1, 0, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0]
_MSE_WEIGHT = [1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0]


# ---------------------------------------------------------------------------
# The parameters: {'actor': [{'b', 'w'}, ...], 'critic': [...], 'logstd'}
# ---------------------------------------------------------------------------

def init_params(seed: int, obs_dim: int, act_dim: int, hidden: int, device,
                logstd: float = -0.5):
    """The weights both sides start from, drawn from ``seed`` on ``device`` in
    one call: each weight N(0, 1/fan_in), biases 0, logstd ``logstd``."""
    dims = [(obs_dim, hidden), (hidden, hidden), (hidden, act_dim),
            (obs_dim, hidden), (hidden, hidden), (hidden, 1)]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn((sum(a * b for a, b in dims),), generator=g, device=device)
    layers, off = [], 0
    for fan_in, fan_out in dims:
        w = flat[off:off + fan_in * fan_out].view(fan_in, fan_out) / math.sqrt(fan_in)
        layers.append({'w': w.contiguous(), 'b': torch.zeros((fan_out,), device=device)})
        off += fan_in * fan_out
    return {'actor': layers[:3], 'critic': layers[3:],
            'logstd': torch.full((act_dim,), logstd, device=device)}


def leaves(tree):
    """The leaves in sorted-key order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def mlp(layers, x):
    h = x
    for layer in layers[:-1]:
        h = torch.tanh(torch.matmul(h, layer['w']) + layer['b'])
    return torch.matmul(h, layers[-1]['w']) + layers[-1]['b']


def log_prob(loc, scale, value):
    var = scale ** 2
    lp = -((value - loc) ** 2) / (2 * var) - torch.log(scale) - 0.5 * _LOG_2PI
    return torch.sum(lp, dim=-1, keepdim=True)


def entropy(loc, scale):
    ent = 0.5 + 0.5 * _LOG_2PI + torch.log(torch.as_tensor(scale))
    return torch.sum(torch.broadcast_to(ent, loc.shape), dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# The env: 3D quadrotor stabilization, batched, with auto-reset
# ---------------------------------------------------------------------------

class Quad3D:
    """``dtype`` float64 widens the program's float32 constants and computes
    every step in float64 (``PPORef``'s float64 witness)."""

    def __init__(self, task, device, dtype=torch.float32):
        q = envcfg.CF2X
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device).to(dtype)
        t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
        self.device, self.dtype = device, dtype
        self.mass, self.Ixx, self.Iyy, self.Izz = f32(q['mass']), f32(q['Ixx']), \
            f32(q['Iyy']), f32(q['Izz'])
        self.arm, self.kf, self.km, self.gravity = f32(q['arm']), f32(q['kf']), \
            f32(q['km']), f32(q['gravity'])
        self.pwm_scale, self.pwm_const = f32(q['pwm2rpm_scale']), f32(q['pwm2rpm_const'])
        self.pwm_min, self.pwm_max = f32(q['min_pwm']), f32(q['max_pwm'])
        self.sqrt2 = f32(_SQRT2_F32)
        self.hover = q['gravity'] * q['mass'] / 4
        self.norm_act_scale = float(task.get('norm_act_scale', 0.1))
        cfg = envcfg.quad3d_cfg(task)
        L = envcfg.QUAD_LAYOUT
        self.phys_lo = t32(np.full(4, cfg[L['PHYS_LO']], np.float32))
        self.phys_hi = t32(np.full(4, cfg[L['PHYS_HI']], np.float32))
        goal = task['task_info']['stabilization_goal']
        self.x_goal = t32(np.atleast_2d(np.hstack([goal[0], 0.0, goal[1], 0.0, goal[2],
                                                   0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])))
        self.tol = task['task_info'].get('stabilization_goal_tolerance', 0.0)
        self.w_state = t32(np.full(12, float(task.get('rew_state_weight', 1.0))))
        self.w_act = t32(np.full(4, float(task.get('rew_act_weight', 0.0001))))
        self.u_goal = t32(np.ones(4) * q['mass'] * q['gravity'] / 4)
        self.w_mse = t32(np.asarray(_MSE_WEIGHT, float))
        lo, hi = envcfg.quad3d_box()
        self.state_lo, self.state_hi = t32(lo), t32(hi)
        self.oob_mask = torch.as_tensor(_OOB_MASK, dtype=torch.bool, device=device)
        self.ctrl_steps = int(task['episode_len_sec'] * int(task['ctrl_freq']))
        self.n_sub, self.dt = envcfg.substeps(task)
        init = task.get('init_state') or {}
        self.nominal = t32([float(init.get(k, 0.0)) for k in envcfg.QUAD3D_LABELS])
        rand = task.get('init_state_randomization_info') or {}
        self.rand = [(k, name, rand[name]) for k, name in enumerate(envcfg.QUAD3D_LABELS)
                     if name in rand] if task.get('randomized_init', True) else []

    def reset(self, gen, n):
        cols = [self.nominal[k].expand(n) for k in range(12)]
        for k, _, info in self.rand:
            b = torch.as_tensor(cols[k], dtype=self.dtype, device=gen.device)
            u = torch.rand(b.shape, generator=gen, device=gen.device).to(self.dtype)
            low = torch.as_tensor(np.float32(info['low']), device=gen.device).to(self.dtype)
            high = torch.as_tensor(np.float32(info['high']), device=gen.device).to(self.dtype)
            cols[k] = b + torch.maximum(low, u * (high - low) + low)
        x0 = torch.stack([c.to(self.dtype) for c in cols], dim=1)
        return x0, torch.zeros((n,), dtype=torch.int32, device=self.device)

    def advance(self, x, clipped):
        thrust = torch.clamp(clipped, min=0.0)
        pwm = (torch.sqrt(thrust / 1 / self.kf) - self.pwm_const) / self.pwm_scale
        pwm = torch.clamp(pwm, self.pwm_min, self.pwm_max)
        rpm = self.pwm_scale * pwm + self.pwm_const
        forces = rpm ** 2 * self.kf
        torques = rpm ** 2 * self.km
        zt = -torques[..., 0] + torques[..., 1] - torques[..., 2] + torques[..., 3]
        dyn = torch.zeros((x.shape[0], 3), dtype=self.dtype, device=self.device)
        out = quad3d_substeps(x.contiguous().unbind(1), forces.contiguous().unbind(1), zt,
                              dyn.unbind(1), self.mass, self.Ixx, self.Iyy, self.Izz,
                              self.arm, self.gravity, self.n_sub, self.dt, self.sqrt2)
        return torch.stack(out, dim=1)

    def step_autoreset(self, x, ctrl_step, actions, gen):
        n = x.shape[0]
        raw = torch.as_tensor(actions, dtype=self.dtype, device=self.device).reshape(n, 4)
        noisy = (1 + self.norm_act_scale * raw) * self.hover
        clipped = torch.minimum(torch.maximum(noisy, self.phys_lo), self.phys_hi)
        x_new = self.advance(x, clipped)
        goal = self.x_goal[0].expand(n, -1)
        err = x_new - goal
        act_err = noisy - self.u_goal
        dist = (self.w_state * err * err).sum(dim=1) + (self.w_act * act_err * act_err).sum(dim=1)
        reward = torch.exp(-dist)
        goal_reached = torch.linalg.vector_norm(x_new - self.x_goal[0], dim=1) < self.tol
        oob = (((x_new < self.state_lo) | (x_new > self.state_hi)) & self.oob_mask).any(dim=1)
        done = goal_reached | oob
        new_step = ctrl_step + 1
        timeout = new_step >= self.ctrl_steps
        truncated = timeout & ~done
        done = done | timeout
        mse = (((x_new - goal) * self.w_mse) ** 2).sum(dim=1)
        fresh, fresh_step = self.reset(gen, n)
        done_col = done[:, None]
        x_next = torch.where(done_col, fresh, x_new)
        step_next = torch.where(done, fresh_step, new_step)
        obs_next = torch.where(done_col, fresh, x_new)
        out = dict(obs=x_new, reward=reward, done=done, truncated=truncated, mse=mse)
        return x_next, step_next, out, obs_next


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

def returns_and_advantages(rews, vals, masks, term_vals, last_val, gamma, lam):
    rews = rews + gamma * term_vals
    ret, adv = last_val, torch.zeros_like(last_val)
    vals_next = torch.cat([vals[1:], last_val[None]], dim=0)
    rets, advs = [], []
    for t in range(rews.shape[0] - 1, -1, -1):
        ret = rews[t] + gamma * masks[t] * ret
        td = rews[t] + gamma * masks[t] * vals_next[t] - vals[t]
        adv = adv * lam * gamma * masks[t] + td
        rets.append(ret)
        advs.append(adv)
    return torch.stack(rets[::-1]), torch.stack(advs[::-1])


def global_norm(ts):
    total = 0
    for t in ts:
        total = total + torch.sum(t * t)
    return torch.sqrt(total)


def clip_adam(params, grads, state, lr, max_norm):
    """Clip by the global norm, then one Adam step, each line one
    ``torch._foreach`` operation over the leaves as the program runs it."""
    norm = global_norm(grads)
    keep = norm < max_norm
    grads = [torch.where(keep, g, (g / norm) * max_norm) for g in grads]
    mu = list(torch._foreach_mul(grads, 1 - B1))
    torch._foreach_add_(mu, torch._foreach_mul(state['mu'], B1))
    nu = list(torch._foreach_mul(grads, grads))
    torch._foreach_mul_(nu, 1 - B2)
    torch._foreach_add_(nu, torch._foreach_mul(state['nu'], B2))
    count = state['count'] + 1
    t = count.to(mu[0].dtype)
    c1 = 1 - torch.pow(B1, t)
    c2 = 1 - torch.pow(B2, t)
    denom = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    updates = list(torch._foreach_div(mu, c1))
    torch._foreach_div_(updates, denom)
    torch._foreach_mul_(updates, -lr)
    return list(torch._foreach_add(params, updates)), {'count': count, 'mu': mu, 'nu': nu}


def adam_init(params):
    return {'count': torch.zeros((), dtype=torch.int32, device=params[0].device),
            'mu': [torch.zeros_like(p) for p in params],
            'nu': [torch.zeros_like(p) for p in params]}


def select(cond, new, old):
    if isinstance(new, dict):
        return {k: select(cond, new[k], old[k]) for k in new}
    if isinstance(new, list):
        return [torch.where(cond, n, o) for n, o in zip(new, old)]
    return torch.where(cond, new, old)


@dataclass
class Iteration:
    losses: list          # policy, value, entropy, approx KL: means over the update
    mean_reward: float
    dones: float


class PPORef:
    """Training from ``params`` with a generator seeded ``gen_seed``. With
    ``dtype`` float64 it is the float64 witness: every draw as in float32,
    then widened, and all arithmetic in float64."""

    def __init__(self, task, algo, params, gen_seed, device, dtype=torch.float32):
        self._setup(task, algo, device, dtype)
        self.gen.manual_seed(int(gen_seed))
        self.params = {'actor': [{k: v.to(dtype) for k, v in l.items()}
                                 for l in params['actor']],
                       'critic': [{k: v.to(dtype) for k, v in l.items()}
                                  for l in params['critic']],
                       'logstd': params['logstd'].to(dtype)}
        self.actor_state = adam_init(leaves(self._actor_sub(self.params)))
        self.critic_state = adam_init(leaves(self.params['critic']))
        self.x, self.step = self.env.reset(self.gen, self.N)
        self.obs = self.x

    def _setup(self, task, algo, device, dtype):
        self.env = Quad3D(task, device, dtype)
        self.a = algo
        self.N, self.T = int(algo['rollout_batch_size']), int(algo['rollout_steps'])
        self.gen = torch.Generator(device=device)
        self.device, self.dtype = device, dtype
        self.first_step_mu = None     # Adam's first moments after the first step

    @classmethod
    def from_state(cls, task, algo, snap, device, dtype=torch.float32):
        """Training that goes on from the program's state ``snap`` (the
        parameters' and both Adam states' leaves, the envs' physical states,
        step counters and obs, and the generator's state), taken just before
        one of its iterations."""
        r = cls.__new__(cls)
        r._setup(task, algo, device, dtype)
        r.gen.set_state(snap['gen'])
        cast = lambda ts: [t.to(dtype, copy=True) for t in ts]
        like = init_params(0, 12, 4, int(algo['hidden_dim']), 'cpu')
        r.params = unflatten(like, cast(snap['params']))
        r.actor_state, r.critic_state = [
            {'count': s['count'].clone(), 'mu': cast(s['mu']), 'nu': cast(s['nu'])}
            for s in (snap['actor_state'], snap['critic_state'])]
        r.x, r.step, r.obs = snap['x'].to(dtype, copy=True), snap['step'].clone(), \
            snap['obs'].to(dtype, copy=True)
        return r

    @staticmethod
    def _actor_sub(p):
        return {'actor': p['actor'], 'logstd': p['logstd']}

    @torch.no_grad()
    def rollout(self):
        p, gamma = self.params, float(self.a['gamma'])
        x, step, obs = self.x, self.step, self.obs
        ys = {k: [] for k in ('obs', 'act', 'rew', 'mask', 'v', 'logp', 'term_v', 'raw_rew',
                              'done')}
        scale = torch.exp(p['logstd'])
        for _ in range(self.T):
            loc = mlp(p['actor'], obs)
            noise = torch.randn(tuple(loc.shape), generator=self.gen, device=self.gen.device)
            act = loc + scale * noise.to(loc.device, self.dtype)
            logp = log_prob(loc, scale, act)
            v = mlp(p['critic'], obs)
            x, step, out, next_obs = self.env.step_autoreset(x, step, act, self.gen)
            rew = out['reward']
            term_v = mlp(p['critic'], out['obs'])
            for k, y in (('obs', obs), ('act', act), ('rew', rew[:, None]),
                         ('mask', 1.0 - out['done'].to(self.dtype)[:, None]), ('v', v),
                         ('logp', logp),
                         ('term_v', torch.where(out['truncated'][:, None], term_v,
                                                torch.zeros_like(term_v))),
                         ('raw_rew', rew), ('done', out['done'])):
                ys[k].append(y)
            obs = next_obs
        ys = {k: torch.stack(v) for k, v in ys.items()}
        last_val = mlp(p['critic'], obs)
        rets, advs = returns_and_advantages(ys['rew'], ys['v'], ys['mask'], ys['term_v'],
                                            last_val, gamma, float(self.a['gae_lambda']))
        advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-6)
        m = self.N * self.T
        batch = {'obs': ys['obs'].reshape(m, -1), 'act': ys['act'].reshape(m, -1),
                 'logp': ys['logp'].reshape(m, -1), 'adv': advs.reshape(m, -1),
                 'ret': rets.reshape(m, -1), 'v': ys['v'].reshape(m, -1)}
        stats = (torch.mean(ys['raw_rew']), torch.sum(ys['done'].to(torch.float32)))
        self.x, self.step, self.obs = x, step, obs
        return batch, stats

    def _minibatch(self, mb):
        a = self.a
        actor_sub = self._actor_sub(self.params)
        a_leaves = [t.detach().requires_grad_(True) for t in leaves(actor_sub)]
        with torch.enable_grad():
            ap = unflatten(actor_sub, a_leaves)
            loc = mlp(ap['actor'], mb['obs'])
            scale = torch.exp(ap['logstd'])
            logp = log_prob(loc, scale, mb['act'])
            ratio = torch.exp(torch.clamp(logp - mb['logp'], -20.0, 20.0))
            clip = float(a['clip_param'])
            clip_adv = torch.clamp(ratio, 1 - clip, 1 + clip) * mb['adv']
            p_loss = -(torch.minimum(ratio * mb['adv'], clip_adv)).mean()
            e_loss = -(entropy(loc, scale)).mean()
            kl = (mb['logp'] - logp).mean()
            total = p_loss + float(a['entropy_coef']) * e_loss
            a_grads = list(torch.autograd.grad(total, a_leaves))
        c_leaves = [t.detach().requires_grad_(True) for t in leaves(self.params['critic'])]
        with torch.enable_grad():
            v_cur = mlp(unflatten(self.params['critic'], c_leaves), mb['obs'])
            v_loss = 0.5 * ((v_cur - mb['ret']) ** 2).mean()
            c_grads = list(torch.autograd.grad(v_loss, c_leaves))
        losses = torch.stack([p_loss, v_loss, e_loss, kl]).detach()
        a_old = [t.detach() for t in a_leaves]
        a_new, a_state_new = clip_adam(a_old, a_grads, self.actor_state, float(a['actor_lr']),
                                       float(a['max_grad_norm']))
        gate = kl.detach() <= 1.5 * float(a['target_kl'])
        a_applied = select(gate, a_new, a_old)
        self.actor_state = select(gate, a_state_new, self.actor_state)
        c_new, self.critic_state = clip_adam([t.detach() for t in c_leaves], c_grads,
                                             self.critic_state, float(a['critic_lr']),
                                             float(a['max_grad_norm']))
        self.params = {**unflatten(actor_sub, a_applied),
                       'critic': unflatten(self.params['critic'], c_new)}
        if self.first_step_mu is None:
            self.first_step_mu = [m.clone() for m in self.actor_state['mu']] + \
                [m.clone() for m in self.critic_state['mu']]
        return losses

    def update(self, batch):
        m = batch['obs'].shape[0]
        mb = min(int(self.a['mini_batch_size']), m)
        num_mb = max(m // mb, 1)
        used = num_mb * mb
        epoch_losses = []
        for _ in range(int(self.a['opt_epochs'])):
            perm = torch.randperm(m, generator=self.gen, device=self.device)[:used]
            losses = [self._minibatch({k: v[perm[i * mb:(i + 1) * mb]] for k, v in batch.items()})
                      for i in range(num_mb)]
            epoch_losses.append(torch.stack(losses).mean(dim=0))
        return torch.stack(epoch_losses).mean(dim=0)

    def iteration(self) -> Iteration:
        batch, (mean_rew, dones) = self.rollout()
        losses = self.update(batch)
        vals = torch.cat([losses, torch.stack([mean_rew, dones])]).cpu().numpy()
        return Iteration([float(v) for v in vals[:4]], float(vals[4]), float(vals[5]))
