"""K4 and K5: the whole open-loop cartpole and quadrotor rollouts in one launch,
as CUDA kernels and in plain PyTorch.

Port of ``safe_control_gym_tpu/ops/rollout_kernels.py``:

* K4, cartpole: ``cartpole_rollout_pallas`` and its body
  ``_cartpole_rollout_kernel``, the cfg layout ``_C`` and
  ``cartpole_rollout_cfg``, as ``cartpole_rollout_kernel`` in
  ``csrc/cartpole_kernels.cu``;
* K5, 2D and 3D quadrotors: ``_quad_rollout_pallas`` and its body
  ``_quad_rollout_kernel`` with the entries ``quad2d_rollout_pallas`` and
  ``quad3d_rollout_pallas``, the cfg layout ``_Q``, ``_QUAD_SHAPE`` and
  ``_quad_rollout_cfg``, as ``quad_rollout_kernel<QT>`` in
  ``csrc/quad_kernels.cu``;

with the coverage gates of the cfg functions and ``rollout_task_kwargs``.

Each of the T steps runs, per env: the action (a uniform draw or the replayed
row), denormalize, white-noise action disturbance, clip, on the quadrotors the
motor model (cmd -> pwm -> rpm -> forces), the physics substeps of K1, K2 or
K3, the reward (``rl_reward`` or quadratic cost), done on goal / out of bounds
/ time limit, the default-box violation count, and the auto-reset; the state,
the step counter and three accumulators are written once at the end.

Design on the card. The TPU kernels ran ``grid=(T,)`` over lane-major (8, B)
or (16, B) blocks. Here one thread owns one env and loops over T, so the
state, the step counter and the accumulators stay in registers for the whole
rollout. Replayed actions come as one contiguous (T, B, nu) tensor (the
per-step path's layout; (T, B) for the cartpole) and are read in place; a
tracking env reads its own waypoint ``x_goal[idx]`` directly, which replaces
the TPU's one-hot matrix gather and its 4096-step cap. At B=4096 one thread
per env is about one warp per SM, so the kernels are bound by the latency of
their serial chain (T x n_substeps dependent substeps), not by FLOP/s or
bytes.

Randomness. A Philox4x32-10 written out in the kernels (``csrc/philox.cuh``),
keyed on ``(seed, 0)`` with the counter ``(env, step, j, 0)``; each j gives
four uint32 words. A uniform is ``(bits >> 8) * 2^-24``.

* K4, j = 0, 1: eight words per env and step, the TPU kernel's eight random
  rows (0: action, 1-2: Box-Muller pair of the action noise, cos half only,
  4-7: the fresh auto-reset state; 0 and 3: the Box-Muller pair of the
  policy mode's exploration noise, cos half, where no action is drawn).
* K5: j = 0 the nu action draws; j = 1 the nu noise uniforms, taken in pairs
  (u1, u2), each pair giving a cos and a sin Box-Muller normal; j = 2 the
  policy mode's exploration noise, paired the same way; j = 3..5 the nx words
  of a fresh auto-reset state. Only the words the flags need are drawn.

The plain versions run the same Philox on int64 tensors and repeat the
kernels' float operations one by one (differences of cfg entries taken in
float32, hoisted physics terms on 0-d float32 tensors), so kernel and plain
version draw identical numbers and can be compared value by value.

Closed loop (``policy_params``, from :func:`pack_policy_params`): the action
comes from the 2-hidden-layer actor MLP on the state at the start of the step
(``_mlp_fwd`` and ``_policy_mean`` of the JAX package), with the frozen
observation normalization folded in, plus optional Gaussian exploration
(``policy_stochastic``, std P_STD) and tanh squash (``policy_squash``); the
rest of the step is unchanged. The weights travel as one contiguous float32
buffer [nmean (nx), ninv (nx), W1 (nx, H1), b1, W2 (H1, H2), b2,
W3 (H2, nu_out), b3], in-major, in place of the TPU's padded (8, H) and
(ROWS, 1) blocks. On the card the policy mode is a kernel of its own: a block
of 256 threads for 32 envs, one thread of warp 0 stepping each env and the
whole block running the actor's products from shared memory
(``csrc/policy_mlp.cuh``, :func:`_policy_launch`). The kernels and the plain
versions accumulate every unit from 0 in ascending input order, one multiply
and one add at a time, so they agree value by value there too.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from safe_control_gym_tpu_torch.ops import _build
from safe_control_gym_tpu_torch.ops._launch import block_size, check_tensor
from safe_control_gym_tpu_torch.ops.physics_kernels import (cartpole_substeps,
                                                             quad2d_substeps,
                                                             quad3d_substeps)

__all__ = ['cartpole_rollout', 'cartpole_rollout_plain', 'cartpole_rollout_cfg',
           'quad2d_rollout', 'quad3d_rollout', 'quad_rollout_plain',
           'quad_rollout_cfg', 'quad2d_rollout_cfg', 'quad3d_rollout_cfg',
           'rollout_task_kwargs', 'PolicyParams',
           'pack_policy_params', 'check_policy_obs', 'policy_mean_plain',
           'philox4x32_10', 'philox_uniform4', 'standard_normal',
           'standard_normal_pair', 'wrap_angle', 'exact_math_check',
           'CARTPOLE_CFG_LEN', 'QUAD_CFG_LEN', 'SPECIALISED_SUBSTEPS', 'SUBSTEP_CHUNK']

_TWO_PI = 6.283185307179586
_INV_2PI = 1.0 / _TWO_PI
_U24 = 2.0 ** -24
_MASK32 = 0xFFFFFFFF

# cfg vector layout (f32), as in the JAX package. Grouped: dynamics, action
# pipeline, task, episode, init randomization, reward weights, constraint box.
_C = dict(
    POLE_MASS=0, CART_MASS=1, POLE_LEN=2, GRAVITY=3,
    ACT_LO=4, ACT_HI=5, ACT_SCALE=6, PHYS_LO=7, PHYS_HI=8,
    GOAL=9,            # 9..12: goal state
    TOL_SQ=13, X_THRESH=14, TH_THRESH=15, MAX_STEPS=16,
    W_ACT=17, NOISE_STD=18,
    INIT_LO=19,        # 19..22: fresh-state low (nominal + rand low)
    INIT_HI=23,        # 23..26: fresh-state high
    W_STATE=27,        # 27..30: reward state weights
    CON_HI=31,         # 31..34: symmetric state-box constraint bound
    P_STD=35,          # 35..38: policy exploration std per action dim
    U_GOAL=39,         # quadratic-cost action reference
)
CARTPOLE_CFG_LEN = 40


def _quad_layout():
    """One cfg layout for both quad types, sized for the 3D case (nx=12,
    nu=4); the 2D kernel reads the first nx / nu entries of each group."""
    names = [('MASS', 1), ('IXX', 1), ('IYY', 1), ('IZZ', 1), ('ARM_L', 1),
             ('GRAVITY', 1), ('KF', 1), ('KM', 1), ('PWM_SCALE', 1),
             ('PWM_CONST', 1), ('PWM_MIN', 1), ('PWM_MAX', 1),
             ('ACT_LO', 1), ('ACT_HI', 1), ('DEN_A', 1), ('DEN_B', 1),
             ('PHYS_LO', 1), ('PHYS_HI', 1),
             ('GOAL', 12), ('TOL_SQ', 1), ('MAX_STEPS', 1),
             ('U_GOAL', 4), ('W_ACT', 4), ('NOISE_STD', 1),
             ('W_STATE', 12), ('INIT_LO', 12), ('INIT_HI', 12),
             ('CON_LO', 12), ('CON_HI', 12), ('P_STD', 4)]
    layout, off = {}, 0
    for name, size in names:
        layout[name] = off
        off += size
    return layout, off


# The quad cfg layout (csrc/quad_kernels.cu keeps the same offsets).
_Q, QUAD_CFG_LEN = _quad_layout()

# State rows, action dims, motors per command, and the position/angle state
# dims checked for out of bounds, per quad type.
_QUAD_SHAPE = {
    2: dict(nx=6, nu=2, n_motor=2, oob_dims=(0, 2, 4)),
    3: dict(nx=12, nu=4, n_motor=1, oob_dims=(0, 2, 4, 6, 7, 8)),
}

# Mode bits of the kernels' ``flags`` argument (csrc/rollout_modes.cuh).
_FLAGS = dict(draw_actions=1, constrained=2, action_noise=4,
              randomized_reset=8, rew_exponential=16, done_on_oob=32,
              tracking=64, quadratic_cost=128, policy=256,
              policy_stochastic=512, policy_squash=1024, policy_relu=2048)

# The policy mode's block (csrc/policy_mlp.cuh kPolicyThreads, kPolicyEnvs):
# 256 threads for a tile of 32 envs. Its dynamic shared memory holds the
# actor's weights and activations; a block may use 232,448 bytes, of which the
# quad kernel's static cfg vector takes 432 (512 kept free). W2 is staged
# whole where it fits, else streamed through two tiles of W2_RING_ROWS rows;
# where not even one tile of all H2 columns and the h2 of H2 units fit, H2
# runs in chunks of fewer units.
_POLICY_THREADS = 256
_POLICY_ENVS = 32
_POLICY_SMEM_MAX = 232448 - 512
_POLICY_W2_RING_ROWS = (32, 16, 8)

# The open loop's substep count compiled in (csrc/*_kernels.cu
# kSpecialisedSubsteps): 1000 Hz physics under 50 Hz control, the benchmark's
# and the committed models' configs. Other counts run a loop over the runtime
# count.
SPECIALISED_SUBSTEPS = 20
# The substeps one unrolled chunk of that loop runs (csrc/rollout_modes.cuh
# kSubstepChunk).
SUBSTEP_CHUNK = 5


class PolicyLaunch(NamedTuple):
    """The launch arguments of a rollout kernel: the packed actor's pointer
    and widths, and the block geometry (envs and threads a block, W2's rows
    and columns a tile, dynamic shared memory bytes). Open loop: no actor,
    ``threads`` a block of one thread per env."""
    ptr: object
    h1: int
    h2: int
    nu_out: int
    envs: int
    threads: int
    w2_rows: int
    w2_cols: int
    smem: int


def _policy_smem_bytes(nx, nu, h1, h2, w2_rows, w2_cols):
    """Dynamic shared memory of a policy launch, as ``PolicyLayout`` in
    csrc/policy_mlp.cuh: W2 whole (a tile of all H1 rows and H2 columns) or
    its two-tile ring of ``w2_rows`` by ``w2_cols``, W1, b1, then b2 and W3's
    first nu columns of one chunk of ``w2_cols`` units of H2, b3[:nu], nmean,
    ninv, then the obs, h1, the chunk's h2 and mu of the block's envs, each
    region rounded up to 4 floats."""
    r4 = lambda n: -(-n // 4) * 4
    w2 = h1 * h2 if (w2_rows, w2_cols) == (h1, h2) else 2 * w2_rows * w2_cols
    e = _POLICY_ENVS
    parts = (w2, nx * h1, h1, w2_cols, w2_cols * nu, nu, nx, nx, nx * e, h1 * e,
             w2_cols * e, nu * e)
    return 4 * sum(r4(n) for n in parts)


def _policy_w2_tile(nx, nu, h1, h2):
    """W2's (rows, columns) a tile: (H1, H2) where the whole actor fits
    beside the activations; else the largest ring tile that divides H1 and
    fits with all H2 columns; else H2 runs chunk by chunk, in the fewest
    chunks of equal width in eighths (the last one narrower) with which a
    ring tile fits. None where nothing fits."""
    fits = lambda rows, cols: _policy_smem_bytes(nx, nu, h1, h2, rows, cols) <= _POLICY_SMEM_MAX
    if fits(h1, h2):
        return h1, h2
    for n_chunks in range(1, h2 // 8 + 1):
        cols = 8 * -(-h2 // (8 * n_chunks))
        for rows in _POLICY_W2_RING_ROWS:
            if h1 % rows == 0 and fits(rows, cols):
                return rows, cols
    return None


# ---------------------------------------------------------------------------
# Philox4x32-10 and the helpers built on it (plain versions)
# ---------------------------------------------------------------------------

def _mulhilo32(a: int, b):
    """(hi, lo) 32-bit halves of the constant ``a`` times the uint32 values
    ``b`` (int64 tensor), without overflowing int64: b is split in 16-bit
    halves so every partial product stays below 2^49."""
    p1 = a * (b >> 16)
    p0 = a * (b & 0xFFFF)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    counter words; returns the four uint32 output words (int64 tensors)."""
    for r in range(10):
        if r > 0:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo32(0xD2511F53, c0)
        hi1, lo1 = _mulhilo32(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform4(seed: int, env_idx, step: int, j: int):
    """Four float32 U[0, 1) per env from counter (env, step, j, 0) under key
    (seed, 0): the high 24 bits of each Philox word times 2^-24."""
    full = lambda v: torch.full_like(env_idx, v)
    words = philox4x32_10(env_idx, full(step & _MASK32), full(j), full(0),
                          int(seed) & _MASK32, 0)
    return [(w >> 8).to(torch.float32) * _U24 for w in words]


def _box_muller_radius(u1):
    return torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))


def standard_normal(u1, u2):
    """Box-Muller, cos half only: two uniforms -> one standard normal."""
    return _box_muller_radius(u1) * torch.cos(_TWO_PI * u2)


def standard_normal_pair(u1, u2):
    """Box-Muller, both halves: two uniforms -> two independent standard
    normals (the cos one, then the sin one)."""
    r = _box_muller_radius(u1)
    a = _TWO_PI * u2
    return r * torch.cos(a), r * torch.sin(a)


def wrap_angle(th):
    """((th + pi) mod 2 pi) - pi with floor semantics, as th - 2 pi floor(...)."""
    return th - _TWO_PI * torch.floor((th + math.pi) * _INV_2PI)


# ---------------------------------------------------------------------------
# The policy mode: the actor MLP inside the rollout
# ---------------------------------------------------------------------------

class PolicyParams(NamedTuple):
    """The packed actor of :func:`pack_policy_params`: the float32 buffer
    [nmean, ninv, W1, b1, W2, b2, W3, b3] and its widths."""
    buffer: torch.Tensor
    nx: int
    h1: int
    h2: int
    nu_out: int


def _numpy(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def pack_policy_params(actor_params, nx: int, obs_mean=None, obs_var=None,
                       device='cuda') -> PolicyParams:
    """Pack an actor MLP (``mlp_init`` layout: three ``{'w' (in, out), 'b'}``,
    tensors or numpy) and optional frozen obs-normalizer stats for the
    rollout's policy mode. The normalization folds into a per-dim shift
    ``nmean`` and scale ``ninv = 1 / sqrt(var + 1e-8)``, computed in numpy
    float32 as the JAX package does (identity without stats)."""
    if len(actor_params) != 3:
        raise ValueError('policy-in-kernel supports exactly 2 hidden layers')
    w1, w2, w3 = (_numpy(layer['w']) for layer in actor_params)
    b1, b2, b3 = (_numpy(layer['b']) for layer in actor_params)
    if w1.shape[0] != nx:
        raise ValueError(f'actor input dim {w1.shape[0]} != state dim {nx}')
    h1, h2, nu_out = w1.shape[1], w2.shape[1], w3.shape[1]
    if w2.shape[0] != h1 or w3.shape[0] != h2:
        raise ValueError('actor layers do not chain: '
                         f'{w1.shape}, {w2.shape}, {w3.shape}')
    nmean = np.zeros(nx, np.float32)
    ninv = np.ones(nx, np.float32)
    if obs_mean is not None:
        nmean[:] = _numpy(obs_mean)
        ninv[:] = 1.0 / np.sqrt(_numpy(obs_var) + 1e-8)
    buf = np.concatenate([nmean, ninv, w1.ravel(), b1, w2.ravel(), b2, w3.ravel(), b3])
    return PolicyParams(torch.as_tensor(buf, device=device).contiguous(), nx, h1, h2,
                        nu_out)


def check_policy_obs(env):
    """Raise ValueError unless the policy sees the raw state: the policy mode
    feeds the state to the actor, so obs must equal state."""
    if env.disturbances.get('observation') is not None:
        raise ValueError('policy-in-kernel rollout: no observation noise')
    if getattr(env, 'obs_goal_horizon', 0):
        raise ValueError('policy-in-kernel rollout: obs == state required '
                         '(obs_goal_horizon unsupported)')
    if getattr(env, 'obs_wrap_angle', False):
        raise ValueError('policy-in-kernel rollout assumes raw-angle obs')


def _policy_views(pp: PolicyParams):
    nx, h1, h2, no = pp.nx, pp.h1, pp.h2, pp.nu_out
    nmean, ninv, w1, b1, w2, b2, w3, b3 = torch.split(
        pp.buffer, [nx, nx, nx * h1, h1, h1 * h2, h2, h2 * no, no])
    return nmean, ninv, w1.view(nx, h1), b1, w2.view(h1, h2), b2, w3.view(h2, no), b3


def policy_mean_plain(pp: PolicyParams, s, nu: int, activation: str = 'tanh',
                      clip_obs: float = 1e30):
    """The first ``nu`` actor outputs on the states ``s`` (a list of nx (B,)
    tensors), as the kernels compute them: the normalized, clipped obs, then
    each layer's units accumulated from 0 over ascending inputs with one
    multiply and one add each, then the bias and the activation."""
    nmean, ninv, w1, b1, w2, b2, w3, b3 = _policy_views(pp)
    act = torch.tanh if activation == 'tanh' else torch.relu
    B = s[0].shape[0]

    def dense(inputs, w, n_out):
        acc = torch.zeros((B, n_out), dtype=torch.float32, device=s[0].device)
        for k, x in enumerate(inputs):
            acc = acc + x[:, None] * w[k, :n_out]
        return acc

    obs = [torch.clamp((s[k] - nmean[k]) * ninv[k], -clip_obs, clip_obs)
           for k in range(pp.nx)]
    h = act(dense(obs, w1, pp.h1) + b1)
    h = act(dense(h.unbind(1), w2, pp.h2) + b2)
    mu = dense(h.unbind(1), w3, nu) + b3[:nu]
    return list(mu.unbind(1))


def _policy_mode(policy_params, policy_activation, draw_actions, actions, name):
    """Validate the policy-mode arguments; True when the mode is on."""
    if policy_params is None:
        return False
    if draw_actions or actions is not None:
        raise ValueError(f'{name}: policy mode replaces the PRNG/replay action '
                         'source (pass draw_actions=False and no actions)')
    if policy_activation not in ('tanh', 'relu'):
        raise ValueError(f'{name}: policy_activation must be tanh or relu, got '
                         f'{policy_activation!r}')
    return True


def _policy_launch(policy_params, nx, nu, B, dev, name) -> PolicyLaunch:
    """The :class:`PolicyLaunch` of a rollout launch. In policy mode: a block
    of 256 threads for 32 envs, hidden widths in multiples of 8, and the
    actor's shared memory within what a block may use (any H2 fits, with H1
    up to 1264 at nx = 12 and 1544 at nx = 4); raises ValueError otherwise."""
    if policy_params is None:
        return PolicyLaunch(None, 0, 0, 0, 0, block_size(B, dev), 0, 0, 0)
    pp = policy_params
    if pp.nx != nx or pp.nu_out < nu:
        raise ValueError(f'{name}: actor {pp.nx} -> {pp.nu_out} does not fit '
                         f'state dim {nx}, action dim {nu}')
    if pp.h1 % 8 or pp.h2 % 8:
        raise ValueError(f'{name}: hidden widths {pp.h1}, {pp.h2} must be multiples of 8')
    tile = _policy_w2_tile(nx, nu, pp.h1, pp.h2)
    if tile is None:
        raise ValueError(f'{name}: actor {nx} -> {pp.h1} -> {pp.h2} needs '
                         f'{_policy_smem_bytes(nx, nu, pp.h1, pp.h2, 8, 8)} bytes of shared '
                         f'memory, more than the {_POLICY_SMEM_MAX} a block may use')
    rows, cols = tile
    check_tensor(pp.buffer, 'policy_params.buffer',
                 (2 * nx + nx * pp.h1 + pp.h1 + pp.h1 * pp.h2 + pp.h2
                  + pp.h2 * pp.nu_out + pp.nu_out,), dev)
    w2_offset = 4 * (2 * nx + nx * pp.h1 + pp.h1)
    if rows != pp.h1 and (pp.buffer.data_ptr() + w2_offset) % 16:
        raise ValueError(f'{name}: W2 must start 16-byte aligned in the packed buffer '
                         'to stream')
    return PolicyLaunch(pp.buffer.data_ptr(), pp.h1, pp.h2, pp.nu_out, _POLICY_ENVS,
                        _POLICY_THREADS, rows, cols,
                        _policy_smem_bytes(nx, nu, pp.h1, pp.h2, rows, cols))


# ---------------------------------------------------------------------------
# The rollout
# ---------------------------------------------------------------------------

def _modes(draw_actions, constrained, action_noise, randomized_reset,
           rew_exponential, done_on_oob, tracking, quadratic_cost, policy=False,
           policy_stochastic=False, policy_squash=False, policy_activation='tanh'):
    return dict(draw_actions=bool(draw_actions), constrained=bool(constrained),
                action_noise=bool(constrained if action_noise is None
                                  else action_noise),
                randomized_reset=bool(randomized_reset),
                rew_exponential=bool(rew_exponential),
                done_on_oob=bool(done_on_oob), tracking=bool(tracking),
                quadratic_cost=bool(quadratic_cost), policy=bool(policy),
                policy_stochastic=bool(policy and policy_stochastic),
                policy_squash=bool(policy and policy_squash),
                policy_relu=bool(policy and policy_activation == 'relu'))


def _flags(m) -> int:
    """The kernels' ``flags`` argument from a ``_modes`` dict."""
    return sum(bit for name, bit in _FLAGS.items() if m[name])


def cartpole_rollout_plain(state0, cfg, seed, n_steps: int, n_substeps: int,
                           dt: float, actions=None, draw_actions: bool = True,
                           constrained: bool = False, action_noise=None,
                           randomized_reset: bool = True,
                           rew_exponential: bool = True,
                           done_on_oob: bool = True, policy_params=None,
                           policy_stochastic: bool = False,
                           policy_squash: bool = False,
                           policy_activation: str = 'tanh',
                           clip_obs: float = 1e30, x_goal=None,
                           quadratic_cost: bool = False):
    """The plain version of K4: the same T-step loop, one PyTorch op at a
    time, on whatever device the inputs are. Arguments and result as
    :func:`cartpole_rollout`."""
    policy = _policy_mode(policy_params, policy_activation, draw_actions, actions,
                          'cartpole_rollout_plain')
    m = _modes(draw_actions, constrained, action_noise, randomized_reset,
               rew_exponential, done_on_oob, x_goal is not None, quadratic_cost,
               policy, policy_stochastic, policy_squash, policy_activation)
    dev = state0.device
    B = state0.shape[0]
    # Scalars of the cfg as Python floats holding float32 values; a difference
    # of two is taken in float32 first, as the kernel does.
    c = np.asarray(cfg.detach().cpu(), np.float32)
    C = lambda k, off=0: float(c[_C[k] + off])
    span = lambda hi, lo, off=0: float(c[_C[hi] + off] - c[_C[lo] + off])
    params = cfg[:4].to(torch.float32)
    zero = torch.zeros((B,), dtype=torch.float32, device=dev)
    env_idx = torch.arange(B, dtype=torch.int64, device=dev)
    n_goal = 1 if x_goal is None else int(x_goal.shape[0])

    x, xd, th, thd = (state0[:, k].to(torch.float32) for k in range(4))
    step = torch.zeros((B,), dtype=torch.int64, device=dev)
    reward_sum = zero.clone()
    done_count = zero.clone()
    viol_count = zero.clone()
    for t in range(n_steps):
        rnd = [None] * 8
        if m['draw_actions'] or m['action_noise'] or m['policy_stochastic']:
            rnd[0:4] = philox_uniform4(seed, env_idx, t, 0)
        if m['randomized_reset']:
            rnd[4:8] = philox_uniform4(seed, env_idx, t, 1)

        # Action pipeline: raw -> physical -> noisy -> clipped.
        if m['policy']:
            # The actor on the state at the start of the step, exploration
            # noise from words 0 and 3, then the squash.
            raw = policy_mean_plain(policy_params, [x, xd, th, thd], 1,
                                    policy_activation, clip_obs)[0]
            if m['policy_stochastic']:
                raw = raw + C('P_STD') * standard_normal(rnd[0], rnd[3])
            if m['policy_squash']:
                raw = torch.tanh(raw)
        elif m['draw_actions']:
            raw = C('ACT_LO') + rnd[0] * span('ACT_HI', 'ACT_LO')
        else:
            raw = actions[t].to(torch.float32)
        phys = raw * C('ACT_SCALE')
        noisy = phys
        if m['action_noise']:
            noisy = phys + C('NOISE_STD') * standard_normal(rnd[1], rnd[2])
        force = torch.clamp(noisy, C('PHYS_LO'), C('PHYS_HI'))

        x, xd, th, thd = cartpole_substeps(x, xd, th, thd, force, zero, zero,
                                           params[0], params[1], params[2],
                                           params[3], n_substeps, dt)

        # Goal: constant, or this env's own waypoint X_GOAL[step + 1]
        # (X_GOAL[step] under the quadratic cost).
        if m['tracking']:
            inc = 0 if m['quadratic_cost'] else 1
            g = x_goal[torch.clamp(step + inc, max=n_goal - 1)]
            g0, g1, g2, g3 = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        else:
            g0, g1, g2, g3 = (C('GOAL', k) for k in range(4))
        e0 = x - g0
        e1 = xd - g1
        e3 = thd - g3
        if m['quadratic_cost']:
            # Unwrapped angle, clipped action against U_GOAL, never exponential.
            e2q = th - g2
            du = force - C('U_GOAL')
            rew = -(C('W_STATE', 0) * e0 * e0 + C('W_STATE', 1) * e1 * e1
                    + C('W_STATE', 2) * e2q * e2q + C('W_STATE', 3) * e3 * e3
                    + C('W_ACT') * du * du)
        else:
            # Wrapped angle and the noisy action.
            ew = wrap_angle(th) - g2
            dist = (C('W_STATE', 0) * e0 * e0 + C('W_STATE', 1) * e1 * e1
                    + C('W_STATE', 2) * ew * ew + C('W_STATE', 3) * e3 * e3
                    + C('W_ACT') * noisy * noisy)
            rew = torch.exp(-dist) if m['rew_exponential'] else -dist

        # Done: goal (stabilization only, unwrapped), out of bounds, time limit.
        if m['tracking']:
            done = torch.zeros((B,), dtype=torch.bool, device=dev)
        else:
            e2 = th - C('GOAL', 2)
            done = e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3 < C('TOL_SQ')
        if m['done_on_oob']:
            done = done | (torch.abs(x) > C('X_THRESH')) \
                | (torch.abs(th) > C('TH_THRESH'))
        new_step = step + 1
        done = done | (new_step.to(torch.float32) >= C('MAX_STEPS'))

        # Default state box and input box, on the noisy pre-clip action.
        if m['constrained']:
            viol = ((torch.abs(x) > C('CON_HI', 0)) | (torch.abs(xd) > C('CON_HI', 1))
                    | (torch.abs(th) > C('CON_HI', 2)) | (torch.abs(thd) > C('CON_HI', 3))
                    | (noisy > C('PHYS_HI')) | (noisy < C('PHYS_LO')))
            viol_count = viol_count + viol.to(torch.float32)

        # Auto-reset: fresh states are drawn every step, selected where done.
        if m['randomized_reset']:
            fresh = [C('INIT_LO', k) + rnd[4 + k] * span('INIT_HI', 'INIT_LO', k)
                     for k in range(4)]
        else:
            fresh = [zero + C('INIT_LO', k) for k in range(4)]
        x = torch.where(done, fresh[0], x)
        xd = torch.where(done, fresh[1], xd)
        th = torch.where(done, fresh[2], th)
        thd = torch.where(done, fresh[3], thd)
        step = torch.where(done, torch.zeros_like(new_step), new_step)
        reward_sum = reward_sum + rew
        done_count = done_count + done.to(torch.float32)
    return {'state': torch.stack([x, xd, th, thd], dim=1),
            'ctrl_step': step.to(torch.float32), 'reward_sum': reward_sum,
            'done_count': done_count, 'violation_count': viol_count}


def _refuse_grad(name, state0, cfg, actions, x_goal, policy_params):
    """Raise where autograd would record a rollout kernel: it has no
    backward, as the JAX package's Pallas rollouts have no VJP. A gradient
    through a rollout goes through ``env.func.step`` (K1-K3)."""
    tensors = (state0, cfg, actions, x_goal,
               policy_params.buffer if policy_params is not None else None)
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f'{name}: the rollout kernel has no gradient; step '
                           'env.func.step (K1-K3) to differentiate, or call it '
                           'under torch.no_grad()')


def cartpole_rollout(state0, cfg, seed, n_steps: int, n_substeps: int,
                     dt: float, actions=None, draw_actions: bool = True,
                     constrained: bool = False, action_noise=None,
                     randomized_reset: bool = True, rew_exponential: bool = True,
                     done_on_oob: bool = True, policy_params=None,
                     policy_stochastic: bool = False, policy_squash: bool = False,
                     policy_activation: str = 'tanh', clip_obs: float = 1e30,
                     x_goal=None, quadratic_cost: bool = False):
    """Run ``n_steps`` full cartpole control steps in one kernel launch (K4).

    Args:
        state0: (B, 4) float32 initial states.
        cfg: (CARTPOLE_CFG_LEN,) float32 config vector (see ``_C``).
        seed: integer Philox key.
        actions: (n_steps, B) float32 raw actions, required when
            ``draw_actions`` is False (replay mode). With ``draw_actions`` the
            actions are drawn iid uniform in [ACT_LO, ACT_HI].
        constrained: count default state-box / input-box violations per env.
        action_noise: draw the NOISE_STD white-noise action disturbance;
            defaults to ``constrained``.
        randomized_reset: draw fresh states uniform in [INIT_LO, INIT_HI];
            otherwise reset to INIT_LO.
        policy_params: closed loop, a :class:`PolicyParams` from
            :func:`pack_policy_params`: the actor MLP on the raw state gives
            the action (needs ``draw_actions=False`` and no ``actions``;
            obs must equal state, :func:`check_policy_obs`).
        policy_stochastic: add N(0, P_STD) exploration noise to the actor's
            mean (Philox words 0 and 3).
        policy_squash: tanh of the (noisy) actor output (the SAC and DDPG
            convention).
        policy_activation: the actor's hidden activation, 'tanh' or 'relu'.
        clip_obs: bound of the normalized policy input.
        x_goal: (n_goal, 4) float32 tracking reference; None = stabilization.
        quadratic_cost: the quadratic cost instead of the RL reward.

    Returns:
        dict of ``state`` (B, 4), ``ctrl_step``, ``reward_sum``,
        ``done_count``, ``violation_count`` (B,), all float32. On the CPU the
        plain version computes them; on a CUDA device the kernel does.
    """
    policy = _policy_mode(policy_params, policy_activation, draw_actions, actions,
                          'cartpole_rollout')
    if not policy and not draw_actions and actions is None:
        raise ValueError('cartpole_rollout: replay mode (draw_actions=False) '
                         'needs actions')
    dev = state0.device
    if dev.type == 'cpu':
        return cartpole_rollout_plain(
            state0, cfg, seed, n_steps, n_substeps, dt, actions=actions,
            draw_actions=draw_actions, constrained=constrained,
            action_noise=action_noise, randomized_reset=randomized_reset,
            rew_exponential=rew_exponential, done_on_oob=done_on_oob,
            policy_params=policy_params, policy_stochastic=policy_stochastic,
            policy_squash=policy_squash, policy_activation=policy_activation,
            clip_obs=clip_obs, x_goal=x_goal, quadratic_cost=quadratic_cost)
    if dev.type != 'cuda':
        raise ValueError(f'cartpole_rollout: unsupported device {dev}')
    _refuse_grad('cartpole_rollout', state0, cfg, actions, x_goal, policy_params)
    m = _modes(draw_actions, constrained, action_noise, randomized_reset,
               rew_exponential, done_on_oob, x_goal is not None, quadratic_cost,
               policy, policy_stochastic, policy_squash, policy_activation)
    B = state0.shape[0]
    check_tensor(state0, 'state0', (B, 4), dev)
    check_tensor(cfg, 'cfg', (CARTPOLE_CFG_LEN,), dev)
    if not m['draw_actions'] and not policy:
        check_tensor(actions, 'actions', (n_steps, B), dev)
    n_goal = 1
    if m['tracking']:
        n_goal = int(x_goal.shape[0])
        check_tensor(x_goal, 'x_goal', (n_goal, 4), dev)
    flags = _flags(m)
    pl = _policy_launch(policy_params, 4, 1, B, dev, 'cartpole_rollout')
    state = torch.empty_like(state0)
    ctrl_step, reward_sum, done_count, violation_count = (
        torch.empty((B,), dtype=torch.float32, device=dev) for _ in range(4))
    lib = _lib()
    err = lib.scg_cartpole_rollout(
        state0.data_ptr(), cfg.data_ptr(),
        actions.data_ptr() if not (m['draw_actions'] or policy) else None,
        x_goal.data_ptr() if m['tracking'] else None, pl.ptr,
        state.data_ptr(), ctrl_step.data_ptr(), reward_sum.data_ptr(),
        done_count.data_ptr(), violation_count.data_ptr(), B, int(n_steps),
        int(n_substeps), float(dt), int(seed) & _MASK32, n_goal, pl.h1, pl.h2, pl.nu_out,
        float(clip_obs), flags, pl.threads, pl.envs, pl.w2_rows, pl.w2_cols,
        pl.smem, torch.cuda.current_stream(dev).cuda_stream)
    cartpole_rollout.launches += 1
    cartpole_rollout.policy_launches += policy
    _build.check(lib, err, 'cartpole_rollout')
    return {'state': state, 'ctrl_step': ctrl_step, 'reward_sum': reward_sum,
            'done_count': done_count, 'violation_count': violation_count}


cartpole_rollout.launches = 0
cartpole_rollout.policy_launches = 0   # the launches in policy mode


def _lib():
    lib = _build.load_library('cartpole_kernels')
    if lib.scg_cartpole_rollout.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.scg_cartpole_rollout.argtypes = [
            p, p, p, p, p, p, p, p, p, p, i, i, i, ctypes.c_float, ctypes.c_uint,
            i, i, i, i, ctypes.c_float, i, i, i, i, i, i, p]
        lib.scg_cartpole_rollout.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# K5: the quadrotor rollout
# ---------------------------------------------------------------------------

def quad_rollout_plain(quad_type: int, state0, cfg, seed, n_steps: int,
                       n_substeps: int, dt: float, actions=None,
                       draw_actions: bool = True, constrained: bool = False,
                       action_noise=None, randomized_reset: bool = True,
                       rew_exponential: bool = True, done_on_oob: bool = True,
                       policy_params=None, policy_stochastic: bool = False,
                       policy_squash: bool = False, policy_activation: str = 'tanh',
                       clip_obs: float = 1e30, x_goal=None,
                       quadratic_cost: bool = False):
    """The plain version of K5 for ``quad_type`` 2 or 3: the same T-step loop,
    one PyTorch op at a time, on whatever device the inputs are. Arguments
    and result as :func:`quad2d_rollout`."""
    shape = _QUAD_SHAPE[quad_type]
    nx, nu = shape['nx'], shape['nu']
    policy = _policy_mode(policy_params, policy_activation, draw_actions, actions,
                          'quad_rollout_plain')
    m = _modes(draw_actions, constrained, action_noise, randomized_reset,
               rew_exponential, done_on_oob, x_goal is not None, quadratic_cost,
               policy, policy_stochastic, policy_squash, policy_activation)
    dev = state0.device
    B = state0.shape[0]
    # Scalars of the cfg as Python floats holding float32 values, and any
    # arithmetic between two of them in float32, as the kernel does it.
    c = np.asarray(cfg.detach().cpu(), np.float32)
    f32 = lambda k, off=0: c[_Q[k] + off]
    C = lambda k, off=0: float(f32(k, off))
    span = lambda hi, lo, off=0: float(f32(hi, off) - f32(lo, off))
    inv_nkf = float(np.float32(1.0) / (np.float32(shape['n_motor']) * f32('KF')))
    inv_scale = float(np.float32(1.0) / f32('PWM_SCALE'))
    two_kf = float(np.float32(2.0) * f32('KF'))
    # The physics parameters as 0-d float32 tensors: the substeps hoist
    # products and quotients of them, which must round in float32.
    P = lambda k: cfg[_Q[k]].to(torch.float32)
    zero = torch.zeros((B,), dtype=torch.float32, device=dev)
    env_idx = torch.arange(B, dtype=torch.int64, device=dev)
    n_goal = 1 if x_goal is None else int(x_goal.shape[0])

    s = [state0[:, k].to(torch.float32) for k in range(nx)]
    step = torch.zeros((B,), dtype=torch.int64, device=dev)
    reward_sum = zero.clone()
    done_count = zero.clone()
    viol_count = zero.clone()
    for t in range(n_steps):
        # Action pipeline: raw -> physical -> noisy -> clipped.
        if m['policy']:
            # The actor on the state at the start of the step, exploration
            # noise from counter word j = 2 in Box-Muller pairs, the squash.
            raw = policy_mean_plain(policy_params, s, nu, policy_activation, clip_obs)
            if m['policy_stochastic']:
                rnd_p = philox_uniform4(seed, env_idx, t, 2)
                for d in range(0, nu, 2):
                    n_cos, n_sin = standard_normal_pair(rnd_p[d], rnd_p[d + 1])
                    raw[d] = raw[d] + C('P_STD', d) * n_cos
                    raw[d + 1] = raw[d + 1] + C('P_STD', d + 1) * n_sin
            if m['policy_squash']:
                raw = [torch.tanh(a) for a in raw]
        elif m['draw_actions']:
            rnd_a = philox_uniform4(seed, env_idx, t, 0)
            raw = [C('ACT_LO') + rnd_a[d] * span('ACT_HI', 'ACT_LO') for d in range(nu)]
        else:
            raw = [actions[t, :, d].to(torch.float32) for d in range(nu)]
        noisy = [C('DEN_A') * a + C('DEN_B') for a in raw]
        if m['action_noise']:
            rnd_n = philox_uniform4(seed, env_idx, t, 1)
            for d in range(0, nu, 2):
                n_cos, n_sin = standard_normal_pair(rnd_n[d], rnd_n[d + 1])
                noisy[d] = noisy[d] + C('NOISE_STD') * n_cos
                noisy[d + 1] = noisy[d + 1] + C('NOISE_STD') * n_sin
        clipped = [torch.clamp(a, C('PHYS_LO'), C('PHYS_HI')) for a in noisy]
        rpm = []
        for a in clipped:
            pwm = (torch.sqrt(torch.clamp(a, min=0.0) * inv_nkf) - C('PWM_CONST')) * inv_scale
            pwm = torch.clamp(pwm, C('PWM_MIN'), C('PWM_MAX'))
            rpm.append(C('PWM_SCALE') * pwm + C('PWM_CONST'))

        # Motor forces and the physics of one control step.
        if quad_type == 2:
            # Pairing [m0, m1, m1, m0]: T1 = f0 + f3 = 2 f(m0), T2 = 2 f(m1).
            T1 = two_kf * rpm[0] * rpm[0]
            T2 = two_kf * rpm[1] * rpm[1]
            s = list(quad2d_substeps(*s, T1, T2, 0.0, 0.0, P('MASS'), P('IYY'),
                                     P('ARM_L'), P('GRAVITY'), n_substeps, dt))
        else:
            forces = [C('KF') * r * r for r in rpm]
            tq = [C('KM') * r * r for r in rpm]
            zt = -tq[0] + tq[1] - tq[2] + tq[3]
            s = list(quad3d_substeps(s, forces, zt, (0.0, 0.0, 0.0), P('MASS'),
                                     P('IXX'), P('IYY'), P('IZZ'), P('ARM_L'),
                                     P('GRAVITY'), n_substeps, dt))

        # Goal: constant, or this env's own waypoint X_GOAL[step + 1] (both
        # costs). Reward: state error and action error against U_GOAL, on the
        # noisy action (RL reward) or the clipped one (quadratic cost, never
        # exponential).
        if m['tracking']:
            g = x_goal[torch.clamp(step + 1, max=n_goal - 1)]
            goal = [g[:, k] for k in range(nx)]
        else:
            goal = [C('GOAL', k) for k in range(nx)]
        dist = zero
        goal_sq = zero
        for k in range(nx):
            e = s[k] - goal[k]
            dist = dist + C('W_STATE', k) * e * e
            goal_sq = goal_sq + e * e
        act_src = clipped if m['quadratic_cost'] else noisy
        for d in range(nu):
            ae = act_src[d] - C('U_GOAL', d)
            dist = dist + C('W_ACT', d) * ae * ae
        if m['rew_exponential'] and not m['quadratic_cost']:
            rew = torch.exp(-dist)
        else:
            rew = -dist

        # Done: goal (stabilization only), position/angle out of bounds on
        # both sides, time limit.
        if m['tracking']:
            done = torch.zeros((B,), dtype=torch.bool, device=dev)
        else:
            done = goal_sq < C('TOL_SQ')
        out_of_box = [(s[k] < C('CON_LO', k)) | (s[k] > C('CON_HI', k)) for k in range(nx)]
        if m['done_on_oob']:
            for k in shape['oob_dims']:
                done = done | out_of_box[k]
        new_step = step + 1
        done = done | (new_step.to(torch.float32) >= C('MAX_STEPS'))

        # Default state box and input box, on the noisy pre-clip commands.
        if m['constrained']:
            viol = torch.zeros((B,), dtype=torch.bool, device=dev)
            for k in range(nx):
                viol = viol | out_of_box[k]
            for a in noisy:
                viol = viol | (a > C('PHYS_HI')) | (a < C('PHYS_LO'))
            viol_count = viol_count + viol.to(torch.float32)

        # Auto-reset: fresh states for the envs that are done.
        if m['randomized_reset']:
            rnd_r = [w for j in range(3, 3 + (nx + 3) // 4)
                     for w in philox_uniform4(seed, env_idx, t, j)]
            fresh = [C('INIT_LO', k) + rnd_r[k] * span('INIT_HI', 'INIT_LO', k)
                     for k in range(nx)]
        else:
            fresh = [zero + C('INIT_LO', k) for k in range(nx)]
        s = [torch.where(done, fresh[k], s[k]) for k in range(nx)]
        step = torch.where(done, torch.zeros_like(new_step), new_step)
        reward_sum = reward_sum + rew
        done_count = done_count + done.to(torch.float32)
    return {'state': torch.stack(s, dim=1), 'ctrl_step': step.to(torch.float32),
            'reward_sum': reward_sum, 'done_count': done_count,
            'violation_count': viol_count}


def _quad_rollout(quad_type: int, wrapper, state0, cfg, seed, n_steps: int,
                  n_substeps: int, dt: float, actions=None,
                  draw_actions: bool = True, constrained: bool = False,
                  action_noise=None, randomized_reset: bool = True,
                  rew_exponential: bool = True, done_on_oob: bool = True,
                  policy_params=None, policy_stochastic: bool = False,
                  policy_squash: bool = False, policy_activation: str = 'tanh',
                  clip_obs: float = 1e30, x_goal=None, quadratic_cost: bool = False):
    name = wrapper.__name__
    policy = _policy_mode(policy_params, policy_activation, draw_actions, actions, name)
    if not policy and not draw_actions and actions is None:
        raise ValueError(f'{name}: replay mode (draw_actions=False) needs actions')
    kw = dict(actions=actions, draw_actions=draw_actions, constrained=constrained,
              action_noise=action_noise, randomized_reset=randomized_reset,
              rew_exponential=rew_exponential, done_on_oob=done_on_oob,
              policy_params=policy_params, policy_stochastic=policy_stochastic,
              policy_squash=policy_squash, policy_activation=policy_activation,
              clip_obs=clip_obs, x_goal=x_goal, quadratic_cost=quadratic_cost)
    dev = state0.device
    if dev.type == 'cpu':
        return quad_rollout_plain(quad_type, state0, cfg, seed, n_steps,
                                  n_substeps, dt, **kw)
    if dev.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {dev}')
    _refuse_grad(name, state0, cfg, actions, x_goal, policy_params)
    m = _modes(draw_actions, constrained, action_noise, randomized_reset,
               rew_exponential, done_on_oob, x_goal is not None, quadratic_cost,
               policy, policy_stochastic, policy_squash, policy_activation)
    nx, nu = _QUAD_SHAPE[quad_type]['nx'], _QUAD_SHAPE[quad_type]['nu']
    B = state0.shape[0]
    check_tensor(state0, 'state0', (B, nx), dev)
    check_tensor(cfg, 'cfg', (QUAD_CFG_LEN,), dev)
    if not m['draw_actions'] and not policy:
        check_tensor(actions, 'actions', (n_steps, B, nu), dev)
    n_goal = 1
    if m['tracking']:
        n_goal = int(x_goal.shape[0])
        check_tensor(x_goal, 'x_goal', (n_goal, nx), dev)
    pl = _policy_launch(policy_params, nx, nu, B, dev, name)
    state = torch.empty_like(state0)
    ctrl_step, reward_sum, done_count, violation_count = (
        torch.empty((B,), dtype=torch.float32, device=dev) for _ in range(4))
    lib = _quad_lib()
    err = lib.scg_quad_rollout(
        quad_type, state0.data_ptr(), cfg.data_ptr(),
        actions.data_ptr() if not (m['draw_actions'] or policy) else None,
        x_goal.data_ptr() if m['tracking'] else None, pl.ptr,
        state.data_ptr(), ctrl_step.data_ptr(), reward_sum.data_ptr(),
        done_count.data_ptr(), violation_count.data_ptr(), B, int(n_steps),
        int(n_substeps), float(dt), int(seed) & _MASK32, n_goal, pl.h1, pl.h2, pl.nu_out,
        float(clip_obs), _flags(m), pl.threads, pl.envs, pl.w2_rows, pl.w2_cols,
        pl.smem, torch.cuda.current_stream(dev).cuda_stream)
    wrapper.launches += 1
    wrapper.policy_launches += policy
    _build.check(lib, err, name)
    return {'state': state, 'ctrl_step': ctrl_step, 'reward_sum': reward_sum,
            'done_count': done_count, 'violation_count': violation_count}


def quad2d_rollout(state0, cfg, seed, n_steps: int, n_substeps: int, dt: float,
                   **kw):
    """Run ``n_steps`` full 2D-quadrotor control steps in one kernel launch (K5).

    Args:
        state0: (B, nx) float32 initial states, nx = 6 here and 12 for
            :func:`quad3d_rollout`.
        cfg: (QUAD_CFG_LEN,) float32 config vector (see ``_Q``).
        seed: integer Philox key.
        actions: (n_steps, B, nu) float32 raw actions, nu = 2 here and 4 in
            3D, required when ``draw_actions`` is False (replay mode). With
            ``draw_actions`` the actions are drawn iid uniform in
            [ACT_LO, ACT_HI].
        constrained: count default state-box / input-box violations per env.
        action_noise: draw the NOISE_STD white-noise action disturbance;
            defaults to ``constrained``.
        randomized_reset: draw fresh states uniform in [INIT_LO, INIT_HI];
            otherwise reset to INIT_LO.
        rew_exponential, done_on_oob: the env's flags of the same names.
        policy_params, policy_stochastic, policy_squash, policy_activation,
            clip_obs: the closed-loop mode, as for :func:`cartpole_rollout`;
            the exploration noise comes from Philox counter word j = 2.
        x_goal: (n_goal, nx) float32 tracking reference; None = stabilization.
        quadratic_cost: the quadratic cost instead of the RL reward.

    Returns:
        dict of ``state`` (B, nx), ``ctrl_step``, ``reward_sum``,
        ``done_count``, ``violation_count`` (B,), all float32. On the CPU the
        plain version computes them; on a CUDA device the kernel does.
    """
    return _quad_rollout(2, quad2d_rollout, state0, cfg, seed, n_steps,
                         n_substeps, dt, **kw)


def quad3d_rollout(state0, cfg, seed, n_steps: int, n_substeps: int, dt: float,
                   **kw):
    """Run ``n_steps`` full 3D-quadrotor control steps in one kernel launch
    (K5); arguments and result as :func:`quad2d_rollout` with nx = 12, nu = 4."""
    return _quad_rollout(3, quad3d_rollout, state0, cfg, seed, n_steps,
                         n_substeps, dt, **kw)


quad2d_rollout.launches = 0
quad3d_rollout.launches = 0
quad2d_rollout.policy_launches = 0   # the launches in policy mode
quad3d_rollout.policy_launches = 0


def _quad_lib():
    lib = _build.load_library('quad_kernels')
    if lib.scg_quad_rollout.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.scg_quad_rollout.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, i, i, i, ctypes.c_float, ctypes.c_uint,
            i, i, i, i, ctypes.c_float, i, i, i, i, i, i, p]
        lib.scg_quad_rollout.restype = ctypes.c_int
        lib.scg_exact_math_check.argtypes = [p, p]
        lib.scg_exact_math_check.restype = ctypes.c_int
    return lib


def exact_math_check(device='cuda'):
    """``csrc/exact_math.cuh``'s branch-free fast paths against the CUDA math
    library on the card (``exact_math_check_kernel``): {'sincos', 'rcp',
    'div': (operands compared, results differing)}, over every float in the
    fast range of sin/cos and of the reciprocal, and 2^32 random quotients."""
    dev = torch.device(device)
    counts = torch.zeros(6, dtype=torch.int64, device=dev)
    lib = _quad_lib()
    _build.check(lib, lib.scg_exact_math_check(counts.data_ptr(),
                                               torch.cuda.current_stream(dev).cuda_stream),
                 'exact_math_check')
    n = [int(v) for v in counts.cpu()]
    return {'sincos': (n[0], n[1]), 'rcp': (n[2], n[3]), 'div': (n[4], n[5])}


# ---------------------------------------------------------------------------
# cfg vector and coverage gates
# ---------------------------------------------------------------------------

def rollout_task_kwargs(env):
    """Extra rollout kwargs for the env's task/cost mode: ``x_goal`` for
    TRAJ_TRACKING, ``quadratic_cost`` for Cost.QUADRATIC; empty for
    stabilization with the RL reward."""
    from safe_control_gym_tpu_torch.envs.benchmark_env import Cost, Task
    kw = {}
    if env.COST == Cost.QUADRATIC:
        kw['quadratic_cost'] = True
    if env.TASK == Task.TRAJ_TRACKING:
        kw['x_goal'] = torch.as_tensor(np.atleast_2d(env.X_GOAL), dtype=torch.float32,
                                       device=env.device).contiguous()
    return kw


def _check_default_constraints(env):
    """Raise ValueError unless the env's constraints are exactly what the
    ``constrained`` kernel hard-codes: the unmodified default state box and
    input box, counted only (no done on violation, no reward penalty)."""
    from safe_control_gym_tpu_torch.envs.constraints import DefaultConstraint
    cl = env.constraints
    if cl is None or not cl.constraints:
        return
    if env.DONE_ON_VIOLATION or env.use_constraint_penalty:
        raise ValueError('fused rollout counts violations only; '
                         'done_on_violation / constraint_penalty unsupported')
    by_var = {c.constrained_variable.value: c for c in cl.constraints}
    if len(cl.constraints) != 2 or set(by_var) != {'state', 'input'}:
        raise ValueError('fused rollout supports exactly the default '
                         'state-box + input-box constraints')
    expected = {'state': (env.state_space.low, env.state_space.high),
                'input': env.physical_action_bounds}
    for var, con in by_var.items():
        lo, hi = expected[var]
        if (type(con) is not DefaultConstraint or con.strict
                or not np.allclose(con.lower_bounds, lo)
                or not np.allclose(con.upper_bounds, hi)):
            raise ValueError('fused rollout supports only the unmodified '
                             f'default {var} box constraint')


def _check_task_cost(env):
    """Raise ValueError outside stabilization/tracking with the RL reward or a
    quadratic cost of diagonal Q/R."""
    from safe_control_gym_tpu_torch.envs.benchmark_env import Cost, Task
    if env.TASK not in (Task.STABILIZATION, Task.TRAJ_TRACKING):
        raise ValueError('fused rollout supports stabilization/tracking')
    if env.COST not in (Cost.RL_REWARD, Cost.QUADRATIC):
        raise ValueError('fused rollout supports rl_reward/quadratic cost')
    if env.COST == Cost.QUADRATIC:
        Q, R = np.asarray(env.Q), np.asarray(env.R)
        if not (np.allclose(Q, np.diag(np.diag(Q)))
                and np.allclose(R, np.diag(np.diag(R)))):
            raise ValueError('fused rollout: diagonal Q/R only')


def cartpole_rollout_cfg(env):
    """The (CARTPOLE_CFG_LEN,) float32 cfg vector of a CartPole env, on the
    env's device. Raises ValueError for configurations the kernel does not
    reproduce. NOISE_STD is left 0: the caller sets it from the action
    disturbance it wants drawn. A state dim missing from the init
    randomization spec stays at its nominal value, as the env's sampler
    leaves it."""
    from safe_control_gym_tpu_torch.envs.benchmark_env import Cost, Task
    _check_task_cost(env)
    if env.RANDOMIZED_INERTIAL_PROP or env.adversary_disturbance:
        raise ValueError('fused rollout needs fixed params, no adversary')
    _check_default_constraints(env)
    if env.obs_wrap_angle:
        raise ValueError('fused rollout assumes raw-angle state obs')
    cfg = np.zeros(CARTPOLE_CFG_LEN, np.float32)
    cfg[_C['POLE_MASS']] = env.POLE_MASS
    cfg[_C['CART_MASS']] = env.CART_MASS
    cfg[_C['POLE_LEN']] = env.EFFECTIVE_POLE_LENGTH
    cfg[_C['GRAVITY']] = env.GRAVITY_ACC
    cfg[_C['ACT_LO']] = env.action_space.low[0]
    cfg[_C['ACT_HI']] = env.action_space.high[0]
    cfg[_C['ACT_SCALE']] = (env.action_scale
                            if env.NORMALIZED_RL_ACTION_SPACE else 1.0)
    cfg[_C['PHYS_LO']] = env.physical_action_bounds[0][0]
    cfg[_C['PHYS_HI']] = env.physical_action_bounds[1][0]
    if env.TASK == Task.STABILIZATION:
        cfg[_C['GOAL']:_C['GOAL'] + 4] = np.atleast_2d(env.X_GOAL)[0]
        tol = float(env.TASK_INFO.get('stabilization_goal_tolerance', 0.0))
        cfg[_C['TOL_SQ']] = tol * tol
    # Tracking: GOAL/TOL_SQ unused; the reference comes in as ``x_goal``.
    cfg[_C['X_THRESH']] = env.x_threshold
    cfg[_C['TH_THRESH']] = env.theta_threshold_radians
    cfg[_C['MAX_STEPS']] = env.CTRL_STEPS
    if env.COST == Cost.QUADRATIC:
        # W_STATE/W_ACT carry 0.5*diag(Q)/(R).
        cfg[_C['W_STATE']:_C['W_STATE'] + 4] = 0.5 * np.diag(env.Q)
        cfg[_C['W_ACT']] = 0.5 * env.R[0, 0]
        cfg[_C['U_GOAL']] = np.atleast_1d(env.U_GOAL)[0]
    else:
        w_a = np.atleast_1d(env.rew_act_weight)
        cfg[_C['W_ACT']] = w_a[0]
        w_s = np.atleast_1d(env.rew_state_weight)
        cfg[_C['W_STATE']:_C['W_STATE'] + 4] = (
            w_s if w_s.size == 4 else np.full(4, w_s[0]))
    nominal = np.array([env.INIT_X, env.INIT_X_DOT, env.INIT_THETA,
                        env.INIT_THETA_DOT], np.float32)
    lo, hi = nominal.copy(), nominal.copy()
    if env.RANDOMIZED_INIT:
        spec = env.INIT_STATE_RAND_INFO
        for k, name in enumerate(('init_x', 'init_x_dot', 'init_theta',
                                  'init_theta_dot')):
            info = spec.get(name)
            if info is None:
                continue      # not randomized: the env's sampler skips it too
            if info.get('distrib') != 'uniform':
                raise ValueError('fused rollout: uniform init rand only')
            lo[k] += info['low']
            hi[k] += info['high']
    cfg[_C['INIT_LO']:_C['INIT_LO'] + 4] = lo
    cfg[_C['INIT_HI']:_C['INIT_HI'] + 4] = hi
    cfg[_C['CON_HI']:_C['CON_HI'] + 4] = env.state_space.high
    return torch.as_tensor(cfg, device=env.device)


def quad_rollout_cfg(env):
    """The (QUAD_CFG_LEN,) float32 cfg vector of a 2D or 3D Quadrotor env, on
    the env's device. Raises ValueError for configurations the kernel does
    not reproduce. NOISE_STD is left 0: the caller sets it from the action
    disturbance it wants drawn. A state dim missing from the init
    randomization spec stays at its nominal value, as the env's sampler
    leaves it."""
    from safe_control_gym_tpu_torch.envs.benchmark_env import Cost, Task
    from safe_control_gym_tpu_torch.envs.quadrotor import QuadType
    _check_task_cost(env)
    if env.RANDOMIZED_INERTIAL_PROP or env.adversary_disturbance:
        raise ValueError('fused rollout needs fixed params, no adversary')
    if env.PHYSICS != 'pyb':
        raise ValueError('fused rollout covers plain pyb physics only')
    if env.QUAD_TYPE not in (QuadType.TWO_D, QuadType.THREE_D):
        raise ValueError('fused rollout covers 2D/3D quads')
    _check_default_constraints(env)
    nx, nu = env.state_dim, env.action_dim
    cfg = np.zeros(QUAD_CFG_LEN, np.float32)
    for name, val in (('MASS', env.MASS), ('IXX', env.J[0, 0]),
                      ('IYY', env.J[1, 1]), ('IZZ', env.J[2, 2]),
                      ('ARM_L', env.L), ('GRAVITY', env.GRAVITY_ACC),
                      ('KF', env.KF), ('KM', env.KM),
                      ('PWM_SCALE', env.PWM2RPM_SCALE),
                      ('PWM_CONST', env.PWM2RPM_CONST),
                      ('PWM_MIN', env.MIN_PWM), ('PWM_MAX', env.MAX_PWM),
                      ('ACT_LO', env.action_space.low[0]),
                      ('ACT_HI', env.action_space.high[0]),
                      ('PHYS_LO', env.physical_action_bounds[0][0]),
                      ('PHYS_HI', env.physical_action_bounds[1][0]),
                      ('TOL_SQ', float(env.TASK_INFO.get(
                          'stabilization_goal_tolerance', 0.0)) ** 2
                       if env.TASK == Task.STABILIZATION else 0.0),
                      ('MAX_STEPS', env.CTRL_STEPS)):
        cfg[_Q[name]] = val
    if env.NORMALIZED_RL_ACTION_SPACE:
        cfg[_Q['DEN_A']] = env.norm_act_scale * env.hover_thrust
        cfg[_Q['DEN_B']] = env.hover_thrust
    else:
        cfg[_Q['DEN_A']] = 1.0
    if env.TASK == Task.STABILIZATION:
        cfg[_Q['GOAL']:_Q['GOAL'] + nx] = np.atleast_2d(env.X_GOAL)[0]
    # Tracking: GOAL/TOL_SQ unused; the reference comes in as ``x_goal``.
    cfg[_Q['U_GOAL']:_Q['U_GOAL'] + nu] = env.U_GOAL
    if env.COST == Cost.QUADRATIC:
        # W_STATE/W_ACT carry 0.5*diag(Q)/(R).
        cfg[_Q['W_STATE']:_Q['W_STATE'] + nx] = 0.5 * np.diag(env.Q)
        cfg[_Q['W_ACT']:_Q['W_ACT'] + nu] = 0.5 * np.diag(env.R)
    else:
        w_a = np.atleast_1d(env.rew_act_weight)
        cfg[_Q['W_ACT']:_Q['W_ACT'] + nu] = w_a if w_a.size == nu else np.full(nu, w_a[0])
        w_s = np.atleast_1d(env.rew_state_weight)
        cfg[_Q['W_STATE']:_Q['W_STATE'] + nx] = w_s if w_s.size == nx else np.full(nx, w_s[0])
    nominal = env._nominal_init_state()
    lo, hi = nominal.copy(), nominal.copy()
    if env.RANDOMIZED_INIT:
        for k, name in enumerate(env.INIT_STATE_LABELS[env.QUAD_TYPE]):
            info = env.INIT_STATE_RAND_INFO.get(name)
            if info is None:
                continue      # not randomized: the env's sampler skips it too
            if info.get('distrib') != 'uniform':
                raise ValueError('fused rollout: uniform init rand only')
            lo[k] += info['low']
            hi[k] += info['high']
    cfg[_Q['INIT_LO']:_Q['INIT_LO'] + nx] = lo
    cfg[_Q['INIT_HI']:_Q['INIT_HI'] + nx] = hi
    cfg[_Q['CON_LO']:_Q['CON_LO'] + nx] = env.state_space.low
    cfg[_Q['CON_HI']:_Q['CON_HI'] + nx] = env.state_space.high
    return torch.as_tensor(cfg, device=env.device)


# The JAX package's names of the same builder, one for each quad type.
quad2d_rollout_cfg = quad_rollout_cfg
quad3d_rollout_cfg = quad_rollout_cfg
