"""BenchmarkEnv: the batched functional env core and a thin stateful shim, in PyTorch.

Port of ``safe_control_gym_tpu/envs/benchmark_env.py``: ``Task``, ``Cost``,
``Environment``, ``EnvState``, ``StepOut``, ``_compile_rand_sampler``, the
functional core built by ``_build_functional`` (``reset_batch``, the step
with a generator or with pre-drawn noise, ``step_autoreset``, ``_observe``),
and the ``reset()`` / ``step()`` shim over a batch of one that returns
numpy; ``set_reference`` swaps ``X_GOAL`` (custom waypoints) and rebuilds
the core around it.

Where the JAX core maps a one-env function with ``vmap``, every function here
takes the batch: states are (B, nx), counters (B,). Where JAX threads PRNG keys,
the port takes an explicit ``torch.Generator`` on the env's device. The step
also takes the channel noise pre-drawn (``drawn``), in the role of the JAX
drawn-mode step, so a caller can feed it the exact noise another
implementation drew.

On a CUDA device the step's physics is a kernel (K1-K3), differentiable
through its plain twin; ``pallas_physics=False``, the JAX package's opt-out,
runs the twin itself.

The reset info carries the env's prior model, ``env.symbolic``
(``envs/symbolic.py``), which each env builds in ``_setup_symbolic``.

The adversary channel of RARL and RAP: with ``adversary_disturbance`` set to
a mode of ``DISTURBANCE_MODES`` ('action' or 'dynamics'), each state carries
``adv_action`` (B, adv_dim) and ``adv_valid`` (B,). Where ``adv_valid`` is
set, the step adds the adversary's action to the noisy physical action before
the clip ('action') or to the dynamics force, the physics kernel's force
operand ('dynamics'), and clears ``adv_valid``. A batched learner writes the
two fields itself; the shim's ``set_adversary_control`` buffers one action
(clipped to ``adversary_action_space``, then scaled and offset) for its next
step.

Domain randomization: with ``randomized_inertial_prop``, each env draws its
own inertial parameters from ``INERTIAL_PROP_RAND_INFO`` (additive draws
around the nominal values, ``_compile_rand_sampler``) at ``reset_batch``,
and ``step_autoreset`` redraws those of the done envs only. The randomized
fields of ``EnvState.dyn_params`` are then (B,) tensors; without it every
field is a 0-d tensor shared by the batch.

The viewer: ``gui=True`` keeps one matplotlib figure (``_LiveViewer``) that
the shim redraws from ``_draw_state`` at every reset and step, live under an
interactive backend and offscreen under Agg. ``render('rgb_array')``
rasterizes the current state to an RGB frame; ``render('human')`` redraws
the viewer. Both read the state on the host, one copy a frame.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from safe_control_gym_tpu_torch.envs import constraints as constraints_mod
from safe_control_gym_tpu_torch.envs import disturbances as disturbances_mod
from safe_control_gym_tpu_torch.envs.spaces import Box
from safe_control_gym_tpu_torch.envs.trajectories import generate_trajectory
from safe_control_gym_tpu_torch.utils.device import resolve_device
from safe_control_gym_tpu_torch.utils.profiling import annotate, count

__all__ = ['Task', 'Cost', 'Environment', 'EnvState', 'StepOut', 'FuncEnv', 'BenchmarkEnv']

_CHANNELS = ('observation', 'action', 'dynamics')


class Task(str, Enum):
    STABILIZATION = 'stabilization'
    TRAJ_TRACKING = 'traj_tracking'


class Cost(str, Enum):
    RL_REWARD = 'rl_reward'
    QUADRATIC = 'quadratic'


class Environment(str, Enum):
    """The implemented environments; a member compares equal to its id."""
    CARTPOLE = 'cartpole'
    QUADROTOR = 'quadrotor'


@dataclass
class EnvState:
    """Per-env simulation state of a batch of B envs."""
    state: torch.Tensor       # (B, nx) physical state
    ctrl_step: torch.Tensor   # (B,) int32 control-step counter
    dyn_params: Any           # inertial parameters: 0-d fields shared, (B,) per env
    dist_obs: torch.Tensor    # (B, state_size) per-episode disturbance state
    dist_act: torch.Tensor
    dist_dyn: torch.Tensor
    adv_action: torch.Tensor  # (B, adv_dim) the adversary's action, scaled
    adv_valid: torch.Tensor   # (B,) bool: adv_action applies at the next step

    def replace(self, **changes) -> 'EnvState':
        return dataclasses.replace(self, **changes)


@dataclass
class StepOut:
    """Batched step output (the functional form of (obs, rew, done, info))."""
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    truncated: torch.Tensor
    mse: torch.Tensor
    constraint_values: torch.Tensor
    constraint_violation: torch.Tensor  # int32 0/1
    goal_reached: torch.Tensor
    out_of_bounds: torch.Tensor
    state: torch.Tensor
    noisy_action: torch.Tensor
    clipped_action: torch.Tensor
    physical_action: torch.Tensor

    def replace(self, **changes) -> 'StepOut':
        return dataclasses.replace(self, **changes)


def _config_tensor(x, device):
    """``x``, a number or list from the config, as float32 on ``device``. To a
    CUDA device that is a copy the host waits on until the card's queue has
    drained: one ``host_reads``."""
    if device.type == 'cuda':
        count('host_reads')
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _compile_rand_sampler(rand_info: Dict[str, Dict], names) -> Callable:
    """Compile a {name: {distrib, args/kwargs}} spec into an additive sampler
    ``fn(gen, base) -> dict``: each named entry of ``base`` (a tensor) plus one
    draw of its shape. Distributions: uniform, normal, choice."""
    entries = []
    for name in names:
        if name not in rand_info:
            continue
        info = dict(rand_info[name])
        distrib = info.pop('distrib')
        args = info.pop('args', [])
        entries.append((name, distrib, args, dict(info)))

    def sample(gen, base):
        out = dict(base)
        for name, distrib, args, kwargs in entries:
            b = torch.as_tensor(base[name], dtype=torch.float32, device=gen.device)
            if distrib == 'uniform':
                low = kwargs.get('low', args[0] if args else 0.0)
                high = kwargs.get('high', args[1] if len(args) > 1 else 1.0)
                u = torch.rand(b.shape, generator=gen, device=gen.device)
                low = _config_tensor(low, gen.device)
                high = _config_tensor(high, gen.device)
                draw = torch.maximum(low, u * (high - low) + low)
            elif distrib in ('normal', 'standard_normal', 'gaussian'):
                loc = kwargs.get('loc', args[0] if args else 0.0)
                scale = kwargs.get('scale', args[1] if len(args) > 1 else 1.0)
                draw = loc + scale * torch.randn(b.shape, generator=gen,
                                                 device=gen.device)
            elif distrib == 'choice':
                options = _config_tensor(args[0], gen.device)
                idx = torch.randint(0, options.shape[0], b.shape, generator=gen,
                                    device=gen.device)
                draw = options[idx]
            else:
                raise ValueError(f'Unsupported randomization distrib: {distrib}')
            out[name] = b + draw
        return out

    return sample


class FuncEnv:
    """Functional view of an env, built by ``BenchmarkEnv._build_functional``.

    * ``reset_batch(gen, n) -> (EnvState, obs)``
    * ``step(est, actions, gen=None, drawn=None) -> (EnvState, StepOut)``
    * ``step_autoreset(est, actions, gen, drawn=None, fresh=None) -> (EnvState, StepOut, obs)``
    * ``draw_noise(gen, n) -> drawn``: one step's draws of every stochastic
      disturbance channel, in the order ``step_autoreset`` makes them

    ``drawn`` maps a disturbance channel ('observation', 'action',
    'dynamics') to that step's pre-drawn noise; a stochastic channel missing
    from it is drawn from ``gen``.
    """

    def __init__(self, reset_batch, step, step_autoreset, draw_noise, obs_dim, act_dim,
                 state_dim, n_constraints, max_steps):
        self.reset_batch = reset_batch
        self.step = step
        self.step_autoreset = step_autoreset
        self.draw_noise = draw_noise
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.state_dim = state_dim
        self.n_constraints = n_constraints
        self.max_steps = max_steps

    def reset(self, gen):
        """One env: ``reset_batch(gen, 1)``."""
        return self.reset_batch(gen, 1)


def _select_params(done, fresh, old):
    """Per-env parameters: ``fresh``'s where ``done`` (B,), else ``old``'s.
    Shared 0-d fields stay as they are."""
    return dataclasses.replace(old, **{
        f.name: torch.where(done, getattr(fresh, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old) if getattr(old, f.name).ndim})


class _LiveViewer:
    """The window of a ``gui=True`` env: one matplotlib figure, cleared and
    redrawn by the env at every reset and step. Under an interactive backend
    it shows and flushes events at each update; under a headless one (Agg)
    the same figure is drawn offscreen. ``frame_count`` counts the redraws."""

    def __init__(self, title='safe-control-gym'):
        import matplotlib
        import matplotlib.pyplot as plt
        self._plt = plt
        backend = matplotlib.get_backend().lower()
        self.interactive = not any(
            backend.startswith(h) for h in
            ('agg', 'pdf', 'svg', 'ps', 'cairo', 'template'))
        self.fig, self.ax = plt.subplots(figsize=(5, 4), dpi=80)
        self.frame_count = 0
        manager = self.fig.canvas.manager
        if manager is not None:
            manager.set_window_title(title)
        if self.interactive:
            plt.ion()
            self.fig.show()

    def update(self, draw_fn):
        """Clear the axes, let the env draw itself, flush."""
        self.ax.cla()
        draw_fn(self.ax)
        self.ax.set_aspect('equal')
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
        else:
            self.fig.canvas.draw()
        self.frame_count += 1

    def close(self):
        self._plt.close(self.fig)


class BenchmarkEnv:
    """Stateful shim that builds the functional core. Subclasses: CartPole,
    Quadrotor."""

    NAME = 'base'
    DISTURBANCE_MODES: Dict[str, Dict] = {}
    INERTIAL_PROP_RAND_INFO: Dict[str, Dict] = {}
    INIT_STATE_RAND_INFO: Dict[str, Dict] = {}
    TASK_INFO: Dict[str, Any] = {}
    AVAILABLE_CONSTRAINTS: Dict[str, Any] = {}

    def __init__(self,
                 output_dir=None,
                 seed: Optional[int] = None,
                 info_in_reset: bool = True,
                 gui: bool = False,
                 verbose: bool = False,
                 normalized_rl_action_space: bool = False,
                 task: str = 'stabilization',
                 cost: str = 'rl_reward',
                 pyb_freq: int = 50,
                 ctrl_freq: int = 50,
                 episode_len_sec: int = 5,
                 init_state=None,
                 randomized_init: bool = True,
                 init_state_randomization_info=None,
                 inertial_prop=None,
                 randomized_inertial_prop: bool = False,
                 inertial_prop_randomization_info=None,
                 task_info=None,
                 constraints=None,
                 done_on_violation: bool = False,
                 use_constraint_penalty: bool = False,
                 constraint_penalty: float = 1.0,
                 disturbances=None,
                 adversary_disturbance=None,
                 adversary_disturbance_offset: float = 0.0,
                 adversary_disturbance_scale: float = 0.01,
                 pallas_physics: bool = True,
                 device='cuda',
                 **kwargs):
        self.device = resolve_device(device)
        # False: the step runs the physics kernel's plain PyTorch twin on
        # any device (the JAX package's opt-out of its Pallas kernel).
        self.pallas_physics = bool(pallas_physics)
        # gui=True: the viewer, built at the first reset.
        self.GUI = gui
        self._viewer = None
        self.VERBOSE = verbose
        self.output_dir = output_dir
        self.NORMALIZED_RL_ACTION_SPACE = normalized_rl_action_space

        # Timing.
        self.CTRL_FREQ = int(ctrl_freq)
        self.PYB_FREQ = int(pyb_freq)
        if self.PYB_FREQ % self.CTRL_FREQ != 0:
            raise ValueError('pyb_freq is not divisible by env_freq.')
        self.PYB_STEPS_PER_CTRL = int(self.PYB_FREQ / self.CTRL_FREQ)
        self.CTRL_TIMESTEP = 1.0 / self.CTRL_FREQ
        self.PYB_TIMESTEP = 1.0 / self.PYB_FREQ
        self.EPISODE_LEN_SEC = episode_len_sec
        self.CTRL_STEPS = int(self.EPISODE_LEN_SEC * self.CTRL_FREQ)

        # Task & cost.
        self.TASK = Task(task)
        self.COST = Cost(cost)
        self.TASK_INFO = dict(self.TASK_INFO, **dict(task_info or {}))

        # Initial state / randomization config.
        self.init_state = init_state
        self.RANDOMIZED_INIT = bool(randomized_init)
        self.INIT_STATE_RAND_INFO = copy.deepcopy(dict(
            init_state_randomization_info if init_state_randomization_info
            is not None else self.INIT_STATE_RAND_INFO))
        self.inertial_prop = inertial_prop
        self.RANDOMIZED_INERTIAL_PROP = bool(randomized_inertial_prop)
        self.INERTIAL_PROP_RAND_INFO = copy.deepcopy(dict(
            inertial_prop_randomization_info if inertial_prop_randomization_info
            is not None else self.INERTIAL_PROP_RAND_INFO))

        # Constraints.
        self.CONSTRAINTS = constraints
        self.DONE_ON_VIOLATION = bool(done_on_violation)
        self.use_constraint_penalty = use_constraint_penalty
        self.constraint_penalty = constraint_penalty
        self.constraints = None

        # Disturbances, and the adversary channel of RARL/RAP.
        self.DISTURBANCES = disturbances
        self.adversary_disturbance = adversary_disturbance
        self.adversary_disturbance_offset = adversary_disturbance_offset
        self.adversary_disturbance_scale = adversary_disturbance_scale
        self.adv_action = None    # the shim's buffered adversary action

        # Mutable episode mirrors (populated by reset/step).
        self.state = None
        self.ctrl_step_counter = 0
        self.pyb_step_counter = 0
        self.current_raw_action = None
        self.current_physical_action = None
        self.current_noisy_physical_action = None
        self.current_clipped_action = None
        self.at_reset = False
        self.initial_reset = False
        self.goal_reached = False
        self.out_of_bounds = False
        self.seed(seed)

    # ------------------------------------------------------------------
    # Seeding: a numpy generator for host-side sampling and a torch
    # generator on the env's device for the functional core.
    # ------------------------------------------------------------------
    def seed(self, seed=None):
        seed = int(seed) if seed is not None else int(
            np.random.SeedSequence().entropy % (2 ** 31))
        self._seed_value = seed
        self.np_random = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        return [seed]

    # ------------------------------------------------------------------
    # Setup helpers called by subclasses
    # ------------------------------------------------------------------
    def _setup_constraints(self):
        self.constraints = None
        self.num_constraints = 0
        if self.CONSTRAINTS is not None:
            self.constraints = constraints_mod.create_constraint_list(
                self.CONSTRAINTS, self.AVAILABLE_CONSTRAINTS, self)
            self.num_constraints = self.constraints.num_constraints

    def _setup_disturbances(self):
        self.disturbances: Dict[str, disturbances_mod.DisturbanceList] = {}
        for mode, spec in dict(self.DISTURBANCES or {}).items():
            if mode not in self.DISTURBANCE_MODES:
                raise ValueError(f'[ERROR] disturbance mode {mode!r} not available.')
            self.disturbances[mode] = disturbances_mod.create_disturbance_list(
                spec, self.DISTURBANCE_MODES[mode], self.CTRL_STEPS)
        if self.adversary_disturbance is not None:
            if self.adversary_disturbance not in self.DISTURBANCE_MODES:
                raise ValueError('[ERROR] adversary_disturbance mode '
                                 f'{self.adversary_disturbance!r} not available.')
            dim = self.DISTURBANCE_MODES[self.adversary_disturbance]['dim']
            self.adversary_action_space = Box(low=-1.0, high=1.0, shape=(dim,))
            self.adv_action_dim = dim
        else:
            self.adversary_action_space = None
            self.adv_action_dim = max((m['dim'] for m in self.DISTURBANCE_MODES.values()),
                                      default=1)

    def set_adversary_control(self, action):
        """Buffer the adversary's action for the shim's next step: clipped to
        ``adversary_action_space``, times the scale, plus the offset (no-op
        without an adversary channel)."""
        if self.adversary_disturbance is not None:
            clipped = np.clip(action, self.adversary_action_space.low,
                              self.adversary_action_space.high)
            self.adv_action = (clipped * self.adversary_disturbance_scale
                               + self.adversary_disturbance_offset)

    def _generate_trajectory(self, **kwargs):
        return generate_trajectory(**kwargs)

    # ------------------------------------------------------------------
    # Subclass hooks for the functional core (all batched)
    # ------------------------------------------------------------------
    def _nominal_dyn_params(self):
        raise NotImplementedError

    def _sample_dyn_params(self, gen, nominal, n: int):
        raise NotImplementedError

    def _nominal_init_state(self) -> np.ndarray:
        raise NotImplementedError

    def _sample_init_state_batch(self, gen, nominal, n: int):
        raise NotImplementedError

    def _denormalize_action(self, action):
        raise NotImplementedError

    def denormalize_action(self, action):
        raise NotImplementedError

    def normalize_action(self, action):
        raise NotImplementedError

    def _advance(self, x, clipped_action, dyn_force, params):
        raise NotImplementedError

    def _rl_reward(self, state, noisy_action, step):
        raise NotImplementedError

    def _quadratic_reward(self, state, clipped_action, step):
        raise NotImplementedError

    def _oob(self, state):
        raise NotImplementedError

    def _mse(self, state, step):
        raise NotImplementedError

    def _setup_symbolic(self, prior_prop={}, **kwargs):
        raise NotImplementedError

    def _obs_transform(self, state):
        """State -> observation before noise and goal extension."""
        return state

    # ------------------------------------------------------------------
    # Functional core
    # ------------------------------------------------------------------
    def _extend_obs(self, obs, next_step):
        """Goal-horizon obs augmentation; ``next_step`` is (B,) int."""
        horizon = getattr(self, 'obs_goal_horizon', 0)
        if self.COST != Cost.RL_REWARD or horizon <= 0:
            return obs
        X_GOAL = self._x_goal
        n = obs.shape[0]
        if self.TASK == Task.TRAJ_TRACKING:
            steps = torch.arange(horizon, device=obs.device)
            idx = torch.clamp(next_step.to(torch.int64)[:, None] + steps, 0,
                              X_GOAL.shape[0] - 1)
            goal = X_GOAL[idx].reshape(n, -1)
        else:
            goal = X_GOAL.reshape(1, -1).expand(n, -1)
        return torch.cat([obs, goal], dim=1)

    def _observe(self, est, x, drawn_obs, at_reset: bool):
        """Noisy observation + goal extension; the next step is 1 at reset and
        ctrl_step + 2 after a step (called before the counter increments)."""
        obs = self._obs_transform(x)
        dist_obs = self.disturbances.get('observation')
        if dist_obs:
            t = est.ctrl_step.to(torch.float32) * self.CTRL_TIMESTEP
            obs = dist_obs.apply_drawn(obs, est.dist_obs, est.ctrl_step, t,
                                       drawn_obs)
        next_step = (torch.ones_like(est.ctrl_step) if at_reset
                     else est.ctrl_step + 2)
        return self._extend_obs(obs, next_step)

    def _build_functional(self):
        """Build the batched reset/step closures over the static config."""
        dev = self.device
        state_dim = self.state_dim
        act_dim = self.action_dim
        CTRL_STEPS = self.CTRL_STEPS
        nominal_params = self._nominal_dyn_params()
        nominal_init = torch.as_tensor(self._nominal_init_state(),
                                       dtype=torch.float32, device=dev)
        phys_lo = torch.as_tensor(np.asarray(self.physical_action_bounds[0], np.float32),
                                  device=dev)
        phys_hi = torch.as_tensor(np.asarray(self.physical_action_bounds[1], np.float32),
                                  device=dev)
        dists = {ch: self.disturbances.get(ch) for ch in _CHANNELS}
        dyn_dim = self.DISTURBANCE_MODES.get('dynamics', {'dim': 1})['dim']
        adv_mode = self.adversary_disturbance
        adv_dim = self.adv_action_dim
        constraints = self.constraints
        n_con = self.num_constraints
        done_on_violation = self.DONE_ON_VIOLATION
        use_penalty = self.use_constraint_penalty
        penalty = self.constraint_penalty
        rew_exponential = bool(getattr(self, 'rew_exponential', True))
        cost = self.COST
        task = self.TASK
        stab_tol = self.TASK_INFO.get('stabilization_goal_tolerance', 0.0)
        self._x_goal = torch.as_tensor(np.atleast_2d(self.X_GOAL), dtype=torch.float32,
                                       device=dev)
        X_GOAL = self._x_goal
        done_on_oob = bool(getattr(self, 'done_on_out_of_bound', False))
        randomized_init = self.RANDOMIZED_INIT
        randomized_prop = self.RANDOMIZED_INERTIAL_PROP
        stochastic = [ch for ch, dl in dists.items() if dl and dl.noise_size > 0]

        def fresh_states(gen, n):
            if randomized_init:
                return self._sample_init_state_batch(gen, nominal_init, n)
            return nominal_init.expand(n, -1).clone()

        def dist_init(ch, gen, n):
            dl = dists[ch]
            if dl is None:
                return torch.zeros((n, 0), device=dev)
            return dl.init(gen, n)

        def reset_batch(gen, n):
            x0 = fresh_states(gen, n)
            est = EnvState(
                state=x0,
                ctrl_step=torch.zeros((n,), dtype=torch.int32, device=dev),
                dyn_params=(self._sample_dyn_params(gen, nominal_params, n)
                            if randomized_prop else nominal_params),
                dist_obs=dist_init('observation', gen, n),
                dist_act=dist_init('action', gen, n),
                dist_dyn=dist_init('dynamics', gen, n),
                adv_action=torch.zeros((n, adv_dim), dtype=torch.float32, device=dev),
                adv_valid=torch.zeros((n,), dtype=torch.bool, device=dev))
            drawn_obs = (dists['observation'].draw(gen, n)
                         if 'observation' in stochastic else None)
            return est, self._observe(est, x0, drawn_obs, at_reset=True)

        def step(est: EnvState, actions, gen=None, drawn=None):
            n = est.state.shape[0]
            drawn = dict(drawn or {})
            for ch in stochastic:
                if ch not in drawn:
                    if gen is None:
                        raise ValueError(f'step: the {ch} disturbance needs a '
                                         'generator or pre-drawn noise')
                    drawn[ch] = dists[ch].draw(gen, n)
            raw = torch.as_tensor(actions, dtype=torch.float32, device=dev)
            raw = raw.reshape(n, act_dim)
            phys = self._denormalize_action(raw)
            t = est.ctrl_step.to(torch.float32) * self.CTRL_TIMESTEP
            noisy = phys
            if dists['action']:
                noisy = dists['action'].apply_drawn(noisy, est.dist_act,
                                                    est.ctrl_step, t,
                                                    drawn.get('action'))
            if adv_mode == 'action':
                noisy = noisy + torch.where(est.adv_valid[:, None],
                                            est.adv_action[:, :act_dim], 0.0)
            clipped = torch.minimum(torch.maximum(noisy, phys_lo), phys_hi)
            dyn_force = torch.zeros((n, dyn_dim), dtype=torch.float32, device=dev)
            if dists['dynamics']:
                dyn_force = dists['dynamics'].apply_drawn(
                    dyn_force, est.dist_dyn, est.ctrl_step, t, drawn.get('dynamics'))
            if adv_mode == 'dynamics':
                dyn_force = dyn_force + torch.where(est.adv_valid[:, None],
                                                    est.adv_action[:, :dyn_dim], 0.0)
            x_new = self._advance(est.state, clipped, dyn_force, est.dyn_params)
            step_idx = est.ctrl_step  # not yet incremented
            est_new = est.replace(state=x_new, adv_valid=torch.zeros_like(est.adv_valid))
            obs = self._observe(est_new, x_new, drawn.get('observation'),
                                at_reset=False)
            if cost == Cost.RL_REWARD:
                reward = self._rl_reward(x_new, noisy, step_idx)
            else:
                reward = self._quadratic_reward(x_new, clipped, step_idx)
            false = torch.zeros((n,), dtype=torch.bool, device=dev)
            if task == Task.STABILIZATION:
                goal_reached = torch.linalg.vector_norm(x_new - X_GOAL[0], dim=1) < stab_tol
            else:
                goal_reached = false
            oob = self._oob(x_new) if done_on_oob else false
            done = goal_reached | oob
            if constraints is not None and n_con > 0:
                c_values = constraints.values_from(x_new, noisy)
                violated = constraints.violated_mask(c_values)
            else:
                c_values = torch.zeros((n, n_con), dtype=torch.float32, device=dev)
                violated = false
            if done_on_violation:
                done = done | violated
            if cost == Cost.RL_REWARD and use_penalty and constraints is not None:
                if rew_exponential:
                    log_rew = torch.log(torch.clamp(reward, min=1e-30)) - penalty
                    reward = torch.where(violated, torch.exp(log_rew), reward)
                else:
                    reward = torch.where(violated, reward - penalty, reward)
            new_step = est.ctrl_step + 1
            timeout = new_step >= CTRL_STEPS
            truncated = timeout & ~done
            done = done | timeout
            out = StepOut(
                obs=obs, reward=reward.to(torch.float32), done=done,
                truncated=truncated,
                mse=self._mse(x_new, step_idx).to(torch.float32),
                constraint_values=c_values,
                constraint_violation=violated.to(torch.int32),
                goal_reached=goal_reached, out_of_bounds=oob, state=x_new,
                noisy_action=noisy, clipped_action=clipped, physical_action=phys)
            return est_new.replace(ctrl_step=new_step), out

        def draw_noise(gen, n):
            return {ch: dists[ch].draw(gen, n) for ch in stochastic}

        def step_autoreset(est: EnvState, actions, gen, drawn=None, fresh=None):
            """``step``, then every done env starts afresh: its state, counter,
            disturbance state, adversary buffer and randomized parameters come
            from a new ``reset_batch`` draw, or from ``fresh``, a ``(EnvState,
            obs)`` of the batch's size drawn beforehand."""
            with annotate('env.step_autoreset'):
                n = est.state.shape[0]
                drawn = dict(drawn or {})
                for ch in stochastic:
                    if ch not in drawn:
                        drawn[ch] = dists[ch].draw(gen, n)
                est, out = step(est, actions, drawn=drawn)
                fresh, fresh_obs = reset_batch(gen, n) if fresh is None else fresh
                done_col = out.done[:, None]
                est = est.replace(
                    state=torch.where(done_col, fresh.state, est.state),
                    ctrl_step=torch.where(out.done, fresh.ctrl_step, est.ctrl_step),
                    dist_obs=torch.where(done_col, fresh.dist_obs, est.dist_obs),
                    dist_act=torch.where(done_col, fresh.dist_act, est.dist_act),
                    dist_dyn=torch.where(done_col, fresh.dist_dyn, est.dist_dyn),
                    adv_action=torch.where(done_col, fresh.adv_action, est.adv_action))
                if randomized_prop:
                    est = est.replace(dyn_params=_select_params(out.done, fresh.dyn_params,
                                                                est.dyn_params))
                obs = torch.where(done_col, fresh_obs, out.obs)
                return est, out, obs

        self.func = FuncEnv(reset_batch, step, step_autoreset, draw_noise,
                            obs_dim=int(np.prod(self.observation_space.shape)),
                            act_dim=act_dim, state_dim=state_dim,
                            n_constraints=n_con, max_steps=CTRL_STEPS)

    # ------------------------------------------------------------------
    # Stateful API: a batch of one, numpy in and out
    # ------------------------------------------------------------------
    def _check_initial_reset(self):
        if not self.initial_reset:
            raise RuntimeError('[ERROR] You must call env.reset() at least once '
                               'before using env.step().')

    def before_reset(self):
        self.initial_reset = True
        self.at_reset = True
        self.ctrl_step_counter = 0
        self.pyb_step_counter = 0
        self.current_raw_action = None
        self.current_physical_action = None
        self.current_noisy_physical_action = None
        self.current_clipped_action = None

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.seed(seed)
        self.before_reset()
        est, obs = self.func.reset_batch(self.generator, 1)
        self._est = est
        self.state = est.state[0].cpu().numpy()
        self.goal_reached = False
        self.out_of_bounds = False
        self.at_reset = False
        info = self._get_reset_info()
        if self.GUI:
            self._update_viewer()
        return obs[0].cpu().numpy(), info

    def step(self, action):
        self._check_initial_reset()
        action = np.atleast_1d(np.squeeze(np.asarray(action)))
        if action.ndim != 1:
            raise ValueError('[ERROR]: The action returned by the controller '
                             'must be 1 dimensional.')
        self.current_raw_action = action
        if self.adv_action is not None:
            adv = np.zeros((1, self.adv_action_dim), np.float32)
            flat = np.atleast_1d(np.asarray(self.adv_action, np.float32)).ravel()
            adv[0, :flat.size] = flat
            self._est = self._est.replace(
                adv_action=torch.as_tensor(adv, device=self.device),
                adv_valid=torch.ones((1,), dtype=torch.bool, device=self.device))
            self.adv_action = None
        est, out = self.func.step(self._est,
                                  torch.as_tensor(action[None], dtype=torch.float32),
                                  gen=self.generator)
        self._est = est
        first = lambda v: v[0].cpu().numpy()
        self.state = first(out.state)
        self.ctrl_step_counter = int(est.ctrl_step[0])
        self.pyb_step_counter = self.ctrl_step_counter * self.PYB_STEPS_PER_CTRL
        self.current_physical_action = first(out.physical_action)
        self.current_noisy_physical_action = first(out.noisy_action)
        self.current_clipped_action = first(out.clipped_action)
        self.goal_reached = bool(out.goal_reached[0])
        self.out_of_bounds = bool(out.out_of_bounds[0])
        info = self._build_info(out)
        if self.GUI:
            self._update_viewer()
        return first(out.obs), float(out.reward[0]), bool(out.done[0]), info

    def set_reference(self, x_goal):
        """Replace ``X_GOAL`` (custom waypoint references) and rebuild the
        functional core around it on the env's device: the reward, the MSE,
        the goal-reached test and the observation's goal extension read the
        new reference from the next step on. The running episode's
        ``EnvState`` is kept. A tracking reference must keep the state's
        width."""
        x_goal = np.asarray(x_goal, np.float32)
        if self.TASK == Task.TRAJ_TRACKING:
            expected = int(np.atleast_2d(np.asarray(self.X_GOAL)).shape[1])
            if np.atleast_2d(x_goal).shape[1] != expected:
                raise ValueError(
                    f'[ERROR] set_reference: expected {expected} state '
                    f'columns, got {np.atleast_2d(x_goal).shape[1]}.')
        self.X_GOAL = x_goal
        self._build_functional()

    def set_state(self, state):
        """Overwrite the physical state mid-episode (GP-MPC's data collection
        starts transitions from chosen states). Returns the observation of the
        new state as ``step`` would give it at the current counter (noise drawn
        from the env's generator where an observation disturbance is set)."""
        self._check_initial_reset()
        x = torch.as_tensor(np.asarray(state, np.float32).reshape(1, self.state_dim),
                            device=self.device)
        est = self._est = self._est.replace(state=x)
        self.state = x[0].cpu().numpy()
        obs = self._obs_transform(x)
        dist_obs = self.disturbances.get('observation')
        if dist_obs:
            drawn = dist_obs.draw(self.generator, 1) if dist_obs.noise_size > 0 else None
            t = est.ctrl_step.to(torch.float32) * self.CTRL_TIMESTEP
            obs = dist_obs.apply_drawn(obs, est.dist_obs, est.ctrl_step, t, drawn)
        return self._extend_obs(obs, est.ctrl_step + 1)[0].cpu().numpy()

    def _build_info(self, out: StepOut) -> Dict[str, Any]:
        info: Dict[str, Any] = {}
        if self.TASK == Task.STABILIZATION and self.COST == Cost.QUADRATIC:
            info['goal_reached'] = bool(out.goal_reached[0])
        if getattr(self, 'done_on_out_of_bound', False):
            info['out_of_bounds'] = bool(out.out_of_bounds[0])
        info['mse'] = float(out.mse[0])
        info['current_step'] = self.ctrl_step_counter
        if self.constraints is not None:
            info['constraint_values'] = out.constraint_values[0].cpu().numpy()
        info['constraint_violation'] = int(out.constraint_violation[0])
        if bool(out.truncated[0]):
            info['TimeLimit.truncated'] = True
        return info

    def _get_reset_info(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {
            'symbolic_model': self.symbolic,
            'physical_parameters': self._physical_parameters(),
            'x_reference': self.X_GOAL,
            'u_reference': self.U_GOAL,
            'current_step': 0,
        }
        if self.constraints is not None:
            info['symbolic_constraints'] = self.constraints.get_all_symbolic_models()
            # Input constraints need an action, which reset does not have.
            info['constraint_values'] = self.constraints.get_values(self, only_state=True)
        return info

    def _physical_parameters(self) -> Dict[str, Any]:
        """This episode's inertial parameters (drawn at the reset where they
        are randomized), one numpy scalar a field."""
        params = self._est.dyn_params
        return {f.name: getattr(params, f.name).reshape(-1)[0].cpu().numpy()
                for f in dataclasses.fields(params)}

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None

    def _update_viewer(self):
        """Draw the current state into the viewer, built at first use."""
        if self._viewer is None:
            self._viewer = _LiveViewer(title=type(self).__name__)
        self._viewer.update(self._draw_state)

    def render(self, mode='rgb_array'):
        """The current state rasterized to an RGB frame (H, W, 3) uint8; with
        ``mode='human'`` the viewer is redrawn instead and None returned."""
        if mode == 'human':
            self._update_viewer()
            return None
        fig, ax = self._render_figure(projection=None)
        self._draw_state(ax)
        ax.set_aspect('equal')
        return self._frame(fig)

    def _render_figure(self, projection):
        """A 4 x 3 in figure at 80 dpi with one axes, under Agg unless the
        viewer is interactive."""
        import matplotlib
        if self._viewer is None or not self._viewer.interactive:
            matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(4, 3), dpi=80)
        return fig, fig.add_subplot(111, projection=projection)

    @staticmethod
    def _frame(fig):
        """The figure's pixels as (H, W, 3) uint8; closes the figure."""
        import matplotlib.pyplot as plt
        fig.canvas.draw()
        frame = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
        plt.close(fig)
        return frame

    def _draw_state(self, ax):
        ax.text(0.5, 0.5, str(np.round(self.state, 2)), ha='center')

    @property
    def state_dim(self):
        return self.state_space.shape[0]

    @property
    def action_dim(self):
        return self.action_space.shape[0]

    @property
    def obs_dim(self):
        return self.observation_space.shape[0]
