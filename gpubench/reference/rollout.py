"""The plain reference of the whole-rollout kernels (K4, cartpole; K5, 3D
quadrotor), open loop and with the actor MLP in the loop.

A frozen copy of the float operations the kernels perform, one PyTorch
operation at a time, in the kernels' order, written here so that it depends
on nothing of the program: the Philox4x32-10 stream keyed on ``(seed, 0)``
with the counter ``(env, step, j, 0)``, the action draw, the white-noise
disturbance (Box-Muller), the clip, the quadrotor's motor model, the physics
substeps (semi-implicit Euler), the reward, done on goal, bounds and time
limit, the constraint-violation count and the auto-reset to a fresh state.
Run on the card, every operation rounds as the kernel's does, so the two are
compared value for value.

The Philox words depend only on (seed, env, step, j), so they are drawn for
every step at once on the host (NumPy, exact integer arithmetic). The rest
depends on the state and runs step by step; on a CUDA device one step is
captured as a CUDA graph and replayed, which runs the same kernels as the
eager operations without the host's cost for each. ``dtype`` other than
float32 gives the lower-precision control.

Rows are any set of (seed, env index, start state); each row is the env of
that index in the launch of that seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.reference import envcfg

_TWO_PI = 6.283185307179586
_INV_2PI = 1.0 / _TWO_PI
_U24 = np.float32(2.0 ** -24)
_M32 = 0xFFFFFFFF
_FOUR_THIRDS = 4.0 / 3.0
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def philox_uniforms(seeds, envs, n_steps: int, j: int) -> np.ndarray:
    """(n_steps, R, 4) float32: the four uniforms of counter (env, step, j, 0)
    under key (seed, 0) for every step and row, each the high 24 bits of a
    Philox4x32-10 word times 2^-24."""
    seeds = np.asarray([int(s) & _M32 for s in seeds], np.uint64)
    envs = np.asarray(envs, np.uint64)
    shape = (n_steps, envs.shape[0])
    c0 = np.broadcast_to(envs[None, :], shape).copy()
    c1 = np.broadcast_to((np.arange(n_steps, dtype=np.uint64) & _M32)[:, None], shape).copy()
    c2 = np.full(shape, j, np.uint64)
    c3 = np.zeros(shape, np.uint64)
    k0 = np.broadcast_to(seeds[None, :], shape).copy()
    k1 = np.zeros(shape, np.uint64)
    m32 = np.uint64(_M32)
    for r in range(10):
        if r > 0:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m32
            k1 = (k1 + np.uint64(0xBB67AE85)) & m32
        p0 = c0 * np.uint64(0xD2511F53)
        p1 = c2 * np.uint64(0xCD9E8D57)
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & m32, \
            (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & m32
    words = np.stack([c0, c1, c2, c3], axis=-1)
    return (words >> np.uint64(8)).astype(np.float32) * _U24


def _radius(u1):
    return torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))


def normal_cos(u1, u2):
    return _radius(u1) * torch.cos(_TWO_PI * u2)


def normal_pair(u1, u2):
    r = _radius(u1)
    a = _TWO_PI * u2
    return r * torch.cos(a), r * torch.sin(a)


def wrap_angle(th):
    return th - _TWO_PI * torch.floor((th + math.pi) * _INV_2PI)


def cartpole_substeps(x, xd, th, thd, force, fx, fz, m, M, L, g, n_substeps, dt):
    Mm = m + M
    ml = m * L
    a11 = Mm
    a22 = _FOUR_THIRDS * m * L * L
    f1 = force + fx
    mgL = m * g * L
    fxL = fx * L
    fzL = fz * L
    a11a22 = a11 * a22
    for _ in range(n_substeps):
        sin_t = torch.sin(th)
        cos_t = torch.cos(th)
        a12 = ml * cos_t
        b1 = f1 + ml * thd * thd * sin_t
        b2 = mgL * sin_t + fxL * cos_t - fzL * sin_t
        inv_det = 1.0 / (a11a22 - a12 * a12)
        x_dd = (a22 * b1 - a12 * b2) * inv_det
        th_dd = (a11 * b2 - a12 * b1) * inv_det
        xd = xd + dt * x_dd
        thd = thd + dt * th_dd
        x = x + dt * xd
        th = th + dt * thd
    return x, xd, th, thd


def quad3d_substeps(state, forces, zt, dist, m, Ixx, Iyy, Izz, L, g, n_substeps, dt, sqrt2):
    """``sqrt2`` is sqrt(2) in float32 as a 0-d tensor: PyTorch's CUDA kernel
    turns a division by a Python scalar into a multiplication by its
    reciprocal, which rounds otherwise than the kernel's division."""
    x, xd, y, yd, z, zd, phi, th, psi, p, q, r = state
    f0, f1, f2, f3 = forces
    fx, fy, fz = dist
    total = f0 + f1 + f2 + f3
    l_sq2 = L / sqrt2
    Mx = l_sq2 * (f0 + f1 - f2 - f3)
    My = l_sq2 * (-f0 + f1 + f2 - f3)
    inv_m = 1.0 / m
    tom = total * inv_m
    fxm = fx * inv_m
    fym = fy * inv_m
    fzm_g = fz * inv_m - g
    c_p = (Izz - Iyy) / Ixx
    c_q = (Ixx - Izz) / Iyy
    c_r = (Iyy - Ixx) / Izz
    Mx_I = Mx / Ixx
    My_I = My / Iyy
    zt_I = zt / Izz
    for _ in range(n_substeps):
        sphi, cphi = torch.sin(phi), torch.cos(phi)
        sth, cth = torch.sin(th), torch.cos(th)
        spsi, cpsi = torch.sin(psi), torch.cos(psi)
        x_dd = (cphi * sth * cpsi + sphi * spsi) * tom + fxm
        y_dd = (cphi * sth * spsi - sphi * cpsi) * tom + fym
        z_dd = cphi * cth * tom + fzm_g
        p_d = Mx_I - q * r * c_p
        q_d = My_I - p * r * c_q
        r_d = zt_I - p * q * c_r
        xd = xd + dt * x_dd
        yd = yd + dt * y_dd
        zd = zd + dt * z_dd
        p = p + dt * p_d
        q = q + dt * q_d
        r = r + dt * r_d
        x = x + dt * xd
        y = y + dt * yd
        z = z + dt * zd
        tth = sth / cth
        phi_d = p + sphi * tth * q + cphi * tth * r
        th_d = cphi * q - sphi * r
        psi_d = sphi / cth * q + cphi / cth * r
        phi = phi + dt * phi_d
        th = th + dt * th_d
        psi = psi + dt * psi_d
    return x, xd, y, yd, z, zd, phi, th, psi, p, q, r


class Actor:
    """The actor MLP as the kernels run it: the normalized, clipped obs, then
    each layer's units accumulated from 0 over ascending inputs, one multiply
    and one add each, then the bias and the activation. ``layers`` is three
    (w (in, out), b) numpy pairs; ``obs_mean``/``obs_var`` the frozen
    normalizer or None."""

    def __init__(self, layers, obs_mean=None, obs_var=None, activation='tanh',
                 clip_obs=1e30, device='cpu', dtype=torch.float32):
        nx = layers[0][0].shape[0]
        nmean = np.zeros(nx, np.float32)
        ninv = np.ones(nx, np.float32)
        if obs_mean is not None:
            nmean[:] = np.asarray(obs_mean, np.float32)
            ninv[:] = 1.0 / np.sqrt(np.asarray(obs_var, np.float32) + 1e-8)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
        self.nmean, self.ninv = t(nmean), t(ninv)
        self.w = [t(w) for w, _ in layers]
        self.b = [t(b) for _, b in layers]
        self.act = torch.tanh if activation == 'tanh' else torch.relu
        self.clip_obs = clip_obs

    def mean(self, s, nu):
        B = s[0].shape[0]

        def dense(inputs, w, n_out):
            acc = torch.zeros((B, n_out), dtype=s[0].dtype, device=s[0].device)
            for k, x in enumerate(inputs):
                acc = acc + x[:, None] * w[k, :n_out]
            return acc

        obs = [torch.clamp((s[k] - self.nmean[k]) * self.ninv[k], -self.clip_obs, self.clip_obs)
               for k in range(len(s))]
        h = self.act(dense(obs, self.w[0], self.w[0].shape[1]) + self.b[0])
        h = self.act(dense(h.unbind(1), self.w[1], self.w[1].shape[1]) + self.b[1])
        mu = dense(h.unbind(1), self.w[2], nu) + self.b[2][:nu]
        return list(mu.unbind(1))


class _Stepper:
    """Runs ``step(t, carry) -> carry`` for t = 0..T-1: eagerly, or on a CUDA
    device as one captured step replayed T times. ``carry`` is a list of
    tensors; ``inputs`` a list of (T, ...) tensors whose row t the step gets."""

    def __init__(self, step, carry, inputs, n_steps, graph):
        self.step, self.carry, self.inputs, self.n_steps = step, carry, inputs, n_steps
        self.graph = graph and carry[0].device.type == 'cuda'

    def run(self):
        if not self.graph:
            carry = self.carry
            for t in range(self.n_steps):
                carry = self.step([u[t] for u in self.inputs], carry)
            return carry
        static = [c.clone() for c in self.carry]
        t_idx = torch.zeros((1,), dtype=torch.int64, device=static[0].device)

        def body():
            rows = [torch.index_select(u, 0, t_idx)[0] for u in self.inputs]
            new = self.step(rows, static)
            for s, n in zip(static, new):
                s.copy_(n)
            t_idx.add_(1)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()                     # the first call outside the capture
        torch.cuda.current_stream().wait_stream(side)
        for s, c in zip(static, self.carry):
            s.copy_(c)
        t_idx.zero_()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            body()
        for s, c in zip(static, self.carry):
            s.copy_(c)
        t_idx.zero_()
        for _ in range(self.n_steps):
            g.replay()
        torch.cuda.synchronize()
        out = [s.clone() for s in static]
        del g
        return out


def _rows_tensor(a, device, dtype):
    return torch.as_tensor(a, device=device).to(dtype)


def cartpole_rollout(cfg: np.ndarray, seeds, envs, state0, n_steps, n_substeps, dt, *,
                     draw_actions=True, constrained=False, action_noise=None,
                     randomized_reset=True, rew_exponential=True, done_on_oob=True,
                     actor: Actor = None, device='cpu', dtype=torch.float32, graph=True):
    """K4's rollout of the rows (seeds[i], envs[i]) from ``state0`` (R, 4).
    ``cfg`` is the (40,) float32 vector of ``envcfg.cartpole_cfg``. Returns
    numpy ``state`` (R, 4), ``ctrl_step``, ``reward_sum``, ``done_count``,
    ``violation_count`` (R,)."""
    L = envcfg.CARTPOLE_LAYOUT
    c = np.asarray(cfg, np.float32)
    C = lambda k, off=0: float(c[L[k] + off])
    span = lambda hi, lo, off=0: float(c[L[hi] + off] - c[L[lo] + off])
    action_noise = constrained if action_noise is None else action_noise
    R = len(envs)
    need_a = draw_actions or action_noise
    inputs = []
    if need_a:
        inputs.append(_rows_tensor(philox_uniforms(seeds, envs, n_steps, 0), device, dtype))
    if randomized_reset:
        inputs.append(_rows_tensor(philox_uniforms(seeds, envs, n_steps, 1), device, dtype))
    cfg_t = torch.as_tensor(c, device=device).to(dtype)
    params = cfg_t[:4]
    zero = torch.zeros((R,), dtype=dtype, device=device)

    def step(rows, carry):
        x, xd, th, thd, stp, reward_sum, done_count, viol_count = carry
        rows = list(rows)
        rnd_a = rows.pop(0) if need_a else None
        rnd_r = rows.pop(0) if randomized_reset else None
        if actor is not None:
            raw = actor.mean([x, xd, th, thd], 1)[0]
        elif draw_actions:
            raw = C('ACT_LO') + rnd_a[:, 0] * span('ACT_HI', 'ACT_LO')
        else:
            raise ValueError('cartpole reference: open loop draws its actions')
        phys = raw * C('ACT_SCALE')
        noisy = phys
        if action_noise:
            noisy = phys + C('NOISE_STD') * normal_cos(rnd_a[:, 1], rnd_a[:, 2])
        force = torch.clamp(noisy, C('PHYS_LO'), C('PHYS_HI'))
        x, xd, th, thd = cartpole_substeps(x, xd, th, thd, force, zero, zero, params[0],
                                           params[1], params[2], params[3], n_substeps, dt)
        g0, g1, g2, g3 = (C('GOAL', k) for k in range(4))
        e0 = x - g0
        e1 = xd - g1
        e3 = thd - g3
        ew = wrap_angle(th) - g2
        dist = (C('W_STATE', 0) * e0 * e0 + C('W_STATE', 1) * e1 * e1
                + C('W_STATE', 2) * ew * ew + C('W_STATE', 3) * e3 * e3
                + C('W_ACT') * noisy * noisy)
        rew = torch.exp(-dist) if rew_exponential else -dist
        e2 = th - C('GOAL', 2)
        done = e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3 < C('TOL_SQ')
        if done_on_oob:
            done = done | (torch.abs(x) > C('X_THRESH')) | (torch.abs(th) > C('TH_THRESH'))
        new_step = stp + 1
        done = done | (new_step.to(dtype) >= C('MAX_STEPS'))
        if constrained:
            viol = ((torch.abs(x) > C('CON_HI', 0)) | (torch.abs(xd) > C('CON_HI', 1))
                    | (torch.abs(th) > C('CON_HI', 2)) | (torch.abs(thd) > C('CON_HI', 3))
                    | (noisy > C('PHYS_HI')) | (noisy < C('PHYS_LO')))
            viol_count = viol_count + viol.to(dtype)
        if randomized_reset:
            fresh = [C('INIT_LO', k) + rnd_r[:, k] * span('INIT_HI', 'INIT_LO', k)
                     for k in range(4)]
        else:
            fresh = [zero + C('INIT_LO', k) for k in range(4)]
        x = torch.where(done, fresh[0], x)
        xd = torch.where(done, fresh[1], xd)
        th = torch.where(done, fresh[2], th)
        thd = torch.where(done, fresh[3], thd)
        stp = torch.where(done, torch.zeros_like(new_step), new_step)
        return [x, xd, th, thd, stp, reward_sum + rew, done_count + done.to(dtype), viol_count]

    s0 = _rows_tensor(state0, device, dtype)
    carry = [s0[:, k].clone() for k in range(4)] + [
        torch.zeros((R,), dtype=torch.int64, device=device), zero.clone(), zero.clone(),
        zero.clone()]
    out = _Stepper(step, carry, inputs, n_steps, graph).run()
    return _result(out, 4)


def quad3d_rollout(cfg: np.ndarray, seeds, envs, state0, n_steps, n_substeps, dt, *,
                   draw_actions=True, constrained=False, action_noise=None,
                   randomized_reset=True, rew_exponential=True, done_on_oob=True,
                   actor: Actor = None, device='cpu', dtype=torch.float32, graph=True):
    """K5's 3D rollout of the rows (seeds[i], envs[i]) from ``state0`` (R, 12);
    ``cfg`` the float32 vector of ``envcfg.quad3d_cfg``. Result as
    :func:`cartpole_rollout`."""
    L = envcfg.QUAD_LAYOUT
    nx, nu, oob_dims = 12, 4, (0, 2, 4, 6, 7, 8)
    c = np.asarray(cfg, np.float32)
    f32 = lambda k, off=0: c[L[k] + off]
    C = lambda k, off=0: float(f32(k, off))
    span = lambda hi, lo, off=0: float(f32(hi, off) - f32(lo, off))
    inv_nkf = float(np.float32(1.0) / (np.float32(1) * f32('KF')))
    inv_scale = float(np.float32(1.0) / f32('PWM_SCALE'))
    action_noise = constrained if action_noise is None else action_noise
    R = len(envs)
    inputs = []
    if actor is None and draw_actions:
        inputs.append(('a', _rows_tensor(philox_uniforms(seeds, envs, n_steps, 0), device, dtype)))
    elif actor is None:
        raise ValueError('quad reference: open loop draws its actions')
    if action_noise:
        inputs.append(('n', _rows_tensor(philox_uniforms(seeds, envs, n_steps, 1), device, dtype)))
    if randomized_reset:
        words = np.concatenate([philox_uniforms(seeds, envs, n_steps, j) for j in (3, 4, 5)],
                               axis=-1)
        inputs.append(('r', _rows_tensor(words, device, dtype)))
    names = [n for n, _ in inputs]
    cfg_t = torch.as_tensor(c, device=device).to(dtype)
    P = lambda k: cfg_t[L[k]]
    sqrt2 = torch.tensor(_SQRT2_F32, dtype=dtype, device=device)
    zero = torch.zeros((R,), dtype=dtype, device=device)

    def step(rows, carry):
        s = list(carry[:nx])
        stp, reward_sum, done_count, viol_count = carry[nx:]
        u = dict(zip(names, rows))
        if actor is not None:
            raw = actor.mean(s, nu)
        else:
            raw = [C('ACT_LO') + u['a'][:, d] * span('ACT_HI', 'ACT_LO') for d in range(nu)]
        noisy = [C('DEN_A') * a + C('DEN_B') for a in raw]
        if action_noise:
            for d in range(0, nu, 2):
                n_cos, n_sin = normal_pair(u['n'][:, d], u['n'][:, d + 1])
                noisy[d] = noisy[d] + C('NOISE_STD') * n_cos
                noisy[d + 1] = noisy[d + 1] + C('NOISE_STD') * n_sin
        clipped = [torch.clamp(a, C('PHYS_LO'), C('PHYS_HI')) for a in noisy]
        rpm = []
        for a in clipped:
            pwm = (torch.sqrt(torch.clamp(a, min=0.0) * inv_nkf) - C('PWM_CONST')) * inv_scale
            pwm = torch.clamp(pwm, C('PWM_MIN'), C('PWM_MAX'))
            rpm.append(C('PWM_SCALE') * pwm + C('PWM_CONST'))
        forces = [C('KF') * r * r for r in rpm]
        tq = [C('KM') * r * r for r in rpm]
        zt = -tq[0] + tq[1] - tq[2] + tq[3]
        s = list(quad3d_substeps(s, forces, zt, (0.0, 0.0, 0.0), P('MASS'), P('IXX'),
                                 P('IYY'), P('IZZ'), P('ARM_L'), P('GRAVITY'), n_substeps, dt,
                                 sqrt2))
        dist = zero
        goal_sq = zero
        for k in range(nx):
            e = s[k] - C('GOAL', k)
            dist = dist + C('W_STATE', k) * e * e
            goal_sq = goal_sq + e * e
        for d in range(nu):
            ae = noisy[d] - C('U_GOAL', d)
            dist = dist + C('W_ACT', d) * ae * ae
        rew = torch.exp(-dist) if rew_exponential else -dist
        done = goal_sq < C('TOL_SQ')
        out_of_box = [(s[k] < C('CON_LO', k)) | (s[k] > C('CON_HI', k)) for k in range(nx)]
        if done_on_oob:
            for k in oob_dims:
                done = done | out_of_box[k]
        new_step = stp + 1
        done = done | (new_step.to(dtype) >= C('MAX_STEPS'))
        if constrained:
            viol = torch.zeros((R,), dtype=torch.bool, device=device)
            for k in range(nx):
                viol = viol | out_of_box[k]
            for a in noisy:
                viol = viol | (a > C('PHYS_HI')) | (a < C('PHYS_LO'))
            viol_count = viol_count + viol.to(dtype)
        if randomized_reset:
            fresh = [C('INIT_LO', k) + u['r'][:, k] * span('INIT_HI', 'INIT_LO', k)
                     for k in range(nx)]
        else:
            fresh = [zero + C('INIT_LO', k) for k in range(nx)]
        s = [torch.where(done, fresh[k], s[k]) for k in range(nx)]
        stp = torch.where(done, torch.zeros_like(new_step), new_step)
        return s + [stp, reward_sum + rew, done_count + done.to(dtype), viol_count]

    s0 = _rows_tensor(state0, device, dtype)
    carry = [s0[:, k].clone() for k in range(nx)] + [
        torch.zeros((R,), dtype=torch.int64, device=device), zero.clone(), zero.clone(),
        zero.clone()]
    out = _Stepper(step, carry, [t for _, t in inputs], n_steps, graph).run()
    return _result(out, nx)


def _result(out, nx):
    f = lambda t: t.to(torch.float64).cpu().numpy()
    return {'state': np.stack([f(t) for t in out[:nx]], axis=1),
            'ctrl_step': f(out[nx]), 'reward_sum': f(out[nx + 1]),
            'done_count': f(out[nx + 2]), 'violation_count': f(out[nx + 3])}


ROLLOUTS = {'cartpole': cartpole_rollout, 'quadrotor_3D': quad3d_rollout}
