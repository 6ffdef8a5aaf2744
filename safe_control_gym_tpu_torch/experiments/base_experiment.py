"""The experiment harness, evaluation half: ``BaseExperiment``,
``RecordDataWrapper`` and ``MetricExtractor``.

Port of ``safe_control_gym_tpu/experiments/base_experiment.py``.
``BaseExperiment`` runs episodes of (env, ctrl, optional safety filter) on
the host, one env step a control step, records every step through
``RecordDataWrapper`` and reduces the records to the standard metrics
(average length, return and RMSE, the CVaR of the RMSE, failure rate and
constraint violations). With a safety filter, an action is denormalized,
certified on the observation's first nx entries and normalized back, so the
filter reasons in physical units.

The JAX package's wrapper is a ``gymnasium.Wrapper``; the port has no
gymnasium, so ``RecordDataWrapper`` is a plain class that hands every other
attribute to the env it wraps. An evaluation of a ``gui=True`` env is paced
to ``visualization_time_multiplier`` times real time: each action after the
first waits out the rest of ``1 / CTRL_FREQ / multiplier`` seconds since the
last (None: unpaced). ``launch_training`` hands training to the parts'
``learn``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from copy import deepcopy

import numpy as np

from safe_control_gym_tpu_torch.math.metrics import compute_cvar

__all__ = ['BaseExperiment', 'RecordDataWrapper', 'MetricExtractor']


class _AttrDict(dict):
    """A dict whose keys are also attributes (the JAX package's
    ``munchify``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc


def _munchify(d):
    if isinstance(d, dict):
        return _AttrDict({k: _munchify(v) for k, v in d.items()})
    return d


def _recorded(env):
    """``env`` wrapped in a RecordDataWrapper, once (None passes through)."""
    if env is None or isinstance(env, RecordDataWrapper):
        return env
    return RecordDataWrapper(env)


def _print_metrics(metrics):
    for name, value in metrics.items():
        if isinstance(value, (list, np.ndarray)):
            print(f'{name}: {[f"{v:.3f}" for v in np.atleast_1d(value)]}')
        else:
            print(f'{name}: {value:.3f}')
    print('Evaluation done.')


class _ResultsTape:
    """Snapshots of the controller's (and the safety filter's)
    ``results_dict``, one a run: at every episode's end, and once more when
    a step budget runs out mid-episode. Each key holds a list with one numpy
    copy a run (``controller_data`` and ``safety_filter_data``)."""

    def __init__(self, ctrl, safety_filter=None):
        self._sources = {'controller_data': ctrl}
        if safety_filter is not None:
            self._sources['safety_filter_data'] = safety_filter
        self._tapes = {name: defaultdict(list) for name in self._sources}
        self.enabled = False  # the first reset comes before any run

    def snapshot(self):
        if not self.enabled:
            return
        for name, source in self._sources.items():
            tape = self._tapes[name]
            for key, val in source.results_dict.items():
                tape[key].append(np.array(deepcopy(val)))

    def attach(self, trajs_data):
        """The recorded tapes merged into the trajectory data."""
        for name, tape in self._tapes.items():
            trajs_data[name] = _munchify(dict(tape))
        return _munchify(trajs_data)


class BaseExperiment:
    """Evaluation episodes of a controller, optionally certified, and their
    metrics."""

    def __init__(self, env, ctrl, train_env=None, safety_filter=None, verbose: bool = False):
        self.env = _recorded(env)
        self.train_env = _recorded(train_env)
        self.ctrl = ctrl
        self.safety_filter = safety_filter
        self.verbose = verbose
        self.metric_extractor = MetricExtractor()
        self.MAX_STEPS = int(env.CTRL_FREQ * env.EPISODE_LEN_SEC)
        # Real-time pacing of GUI evaluations.
        self.visualization_time_multiplier = 1
        self._last_step_wall = None

    def _parts(self):
        """(name, part) of the parts present, in the order reset and close
        take them."""
        for name in ('env', 'ctrl', 'safety_filter', 'train_env'):
            part = getattr(self, name)
            if part is not None:
                yield name, part

    def reset(self):
        for name, part in self._parts():
            part.reset()
            if name.endswith('env'):
                part.clear_data()

    def close(self):
        for _, part in self._parts():
            part.close()

    def load(self, ctrl_path=None, safety_filter_path=None):
        self._move_artifacts('load', ctrl_path, safety_filter_path)

    def save(self, ctrl_path=None, safety_filter_path=None):
        self._move_artifacts('save', ctrl_path, safety_filter_path)

    def _move_artifacts(self, direction, ctrl_path, safety_filter_path):
        for part, path in ((self.ctrl, ctrl_path), (self.safety_filter, safety_filter_path)):
            if path is not None:
                getattr(part, direction)(path)

    # -- evaluation ----------------------------------------------------
    def run_evaluation(self, training=False, n_episodes=None, n_steps=None,
                       done_on_max_steps=None, log_freq=None, verbose=True,
                       visualization_time_multiplier=1, **kwargs):
        """Evaluate the controller for ``n_episodes`` or ``n_steps``;
        returns (trajectory data, metrics). ``visualization_time_multiplier``
        paces a ``gui=True`` env's steps (1 real time, 2 twice as fast, None
        unpaced)."""
        self.visualization_time_multiplier = visualization_time_multiplier
        self._last_step_wall = None
        if not training:
            self.reset()
        trajs_data = self._execute_evaluations(log_freq=log_freq, n_episodes=n_episodes,
                                               n_steps=n_steps,
                                               done_on_max_steps=done_on_max_steps, **kwargs)
        metrics = self.compute_metrics(trajs_data)
        if verbose:
            _print_metrics(metrics)
        return dict(trajs_data), metrics

    def _execute_evaluations(self, n_episodes=None, n_steps=None, done_on_max_steps=None,
                             log_freq=None, seeds=None):
        """Roll out until the episode or the step budget is spent; each
        episode's seed (if given) goes to its reset."""
        if (n_episodes is None) == (n_steps is None):
            raise ValueError('Exactly one of n_episodes or n_steps must be defined.')
        if seeds is not None:
            assert len(seeds) == n_episodes, 'Number of seeds must match the number of episodes'
        sim_steps = log_freq // self.env.CTRL_FREQ if log_freq else 1
        self._tape = _ResultsTape(self.ctrl, self.safety_filter)
        self._episode_steps = 0   # steps since the last reset
        self._episodes_done = 0
        self._seeds = seeds
        obs, info = self._evaluation_reset(seed=seeds[0] if seeds is not None else None)
        self._tape.enabled = True
        budget_left = ((lambda: self._episodes_done < n_episodes) if n_episodes is not None
                       else (lambda: self._episode_steps < n_steps))
        while budget_left():
            action = self._select_action(obs=obs, info=info)
            for _ in range(sim_steps):
                self._episode_steps += 1
                obs, _, done, info = self.env.step(action)
                if n_steps is not None and self._episode_steps >= n_steps:
                    # The step budget ends mid-episode: close out the data
                    # without a reset.
                    self.env.save_data()
                    self._tape.snapshot()
                    break
                if done_on_max_steps:
                    done = done and self._episode_steps >= self.MAX_STEPS
                if done:
                    obs, info = self._on_episode_end(n_episodes)
                    break
        return self._tape.attach(self.env.data)

    def _on_episode_end(self, n_episodes):
        """Roll the episode's data, take the next seed and reset."""
        self._episodes_done += 1
        self._episode_steps = 0
        self.env.save_data()
        next_seed = None
        if self._seeds is not None and n_episodes is not None \
                and self._episodes_done < n_episodes:
            next_seed = self._seeds[self._episodes_done]
        return self._evaluation_reset(seed=next_seed)

    def _select_action(self, obs, info):
        """The controller's action, certified by the safety filter if there
        is one: denormalize, certify on obs[:nx], normalize."""
        action = self.ctrl.select_action(obs, info)
        if self.safety_filter is not None:
            certified, ok = self.safety_filter.certify_action(
                np.asarray(obs)[:self.env.symbolic.nx], self.env.denormalize_action(action),
                info)
            if ok:
                action = self.env.normalize_action(certified)
        self._pace_visualization()
        return action

    def _pace_visualization(self):
        """Sleep so that a GUI evaluation runs at the multiplier times real
        time; no sleep for a headless env or a multiplier of None."""
        mult = self.visualization_time_multiplier
        now = time.time()
        if self._last_step_wall is not None \
                and getattr(self.env, 'GUI', False) is True and mult is not None:
            elapsed = now - self._last_step_wall
            time.sleep(max(0.0, 1.0 / self.env.CTRL_FREQ / mult - elapsed))
            now = time.time()
        self._last_step_wall = now

    def _evaluation_reset(self, seed=None):
        """Snapshot the results, then reset the env, the controller and the
        filter for the next run."""
        tape = getattr(self, '_tape', None)
        if tape is not None:
            tape.snapshot()
        obs, info = self.env.reset(seed=seed)
        self.ctrl.reset_before_run(obs, info, env=self.env)
        if self.safety_filter is not None:
            self.safety_filter.reset_before_run(env=self.env)
        return obs, info

    # -- training ------------------------------------------------------
    def launch_training(self, **kwargs):
        """Hand training to each part's ``learn``."""
        self.reset()
        for _, part in self._parts():
            if hasattr(part, 'learn'):
                part.learn(env=self.train_env, **kwargs)
        print('Training done.')
        return dict(self.train_env.data if self.train_env is not None else {})

    def compute_metrics(self, trajs_data):
        return self.metric_extractor.compute_metrics(data=trajs_data, verbose=self.verbose)


class RecordDataWrapper:
    """Per-step data logging around an env.

    Each recorded channel is a row of the tables below: its key in
    ``episode_data`` and what it takes from the env and the transition.
    ``save_data`` rolls the open episode into ``data`` as one numpy array an
    episode (info dicts as object arrays). Every other attribute is the
    wrapped env's."""

    #: reset-time channels: key -> grab(env, obs, info)
    RESET_CHANNELS = (
        ('obs', lambda env, obs, info: obs),
        ('info', lambda env, obs, info: info),
        ('state', lambda env, obs, info: env.state),
    )
    #: step-time channels: key -> grab(env, (obs, reward, done, info))
    STEP_CHANNELS = (
        ('obs', lambda env, t: t[0]),
        ('action', lambda env, t: env.current_raw_action),
        ('done', lambda env, t: float(t[2])),
        ('info', lambda env, t: t[3]),
        ('reward', lambda env, t: t[1]),
        ('length', lambda env, t: 1),
        ('state', lambda env, t: env.state),
        ('current_physical_action', lambda env, t: env.current_physical_action),
        ('current_noisy_physical_action', lambda env, t: env.current_noisy_physical_action),
        ('current_clipped_action', lambda env, t: env.current_clipped_action),
        ('timestamp', lambda env, t: time.time()),
    )

    def __init__(self, env):
        self.env = env
        self.clear_data()

    def __getattr__(self, name):
        if name.startswith('_') or name == 'env':
            raise AttributeError(name)
        return getattr(self.env, name)

    def clear_data(self):
        self.data = defaultdict(list)
        self.episode_data = defaultdict(list)

    def save_data(self):
        """Roll the open episode's channels into the per-episode arrays."""
        if not self.episode_data:
            return
        episode, self.episode_data = self.episode_data, defaultdict(list)
        for key, steps in episode.items():
            self.data[key].append(np.array(deepcopy(steps),
                                           dtype=object if key == 'info' else None))

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        info.pop('symbolic_model', None)
        info.pop('symbolic_constraints', None)
        for key, grab in self.RESET_CHANNELS:
            self.episode_data[key].append(grab(self.env, obs, info))
        return obs, info

    def step(self, action):
        transition = self.env.step(action)
        for key, grab in self.STEP_CHANNELS:
            self.episode_data[key].append(grab(self.env, transition))
        return transition

    def close(self):
        self.env.close()


class MetricExtractor:
    """The standard metrics of recorded trajectory data: each key maps to a
    list of per-episode arrays; per-step scalars (``mse``,
    ``constraint_violation``) come from a top-level key or else from the
    per-step info dicts, in the JAX package's order."""

    def compute_metrics(self, data, verbose=False):
        self.data = data
        self.verbose = verbose
        lengths = self.get_episode_lengths()
        rmse = np.asarray(self.get_episode_rmse())
        violations = np.asarray(self.get_episode_constraint_violation_steps())

        def per_episode_or_scalar(seq):
            # The vector of a multi-episode run, the bare value of one.
            return seq if len(seq) > 1 else seq[0]

        return {
            'average_length': np.asarray(lengths).mean(),
            'length': per_episode_or_scalar(lengths),
            'average_return': np.asarray(self.get_episode_returns()).mean(),
            'average_rmse': rmse.mean(),
            'rmse': per_episode_or_scalar(rmse),
            'rmse_std': rmse.std(),
            'worst_case_rmse_at_0.5': compute_cvar(rmse, 0.5, lower_range=False),
            'failure_rate': np.asarray(self.get_episode_constraint_violations()).mean(),
            'average_constraint_violation': violations.mean(),
            'constraint_violation_std': violations.std(),
            'constraint_violation': per_episode_or_scalar(violations),
        }

    def get_episode_data(self, key, postprocess_func=lambda x: x):
        """One channel reduced per episode: a top-level channel first, then
        the per-step info dicts' entries."""
        if key in self.data:
            return [postprocess_func(ep) for ep in self.data[key]]
        if key in self.data['info'][0][-1]:
            return [postprocess_func(self._from_infos(ep_info, key))
                    for ep_info in self.data['info']]
        raise KeyError(f"Given data key '{key}' does not exist in recorded trajectory data.")

    def _from_infos(self, ep_info, key):
        values = []
        for info in ep_info:
            if key in info:
                values.append(info[key])
            elif self.verbose:
                print(f'[Warn] MetricExtractor.get_episode_data: key {key} not in info dict.')
        return values

    def get_episode_lengths(self):
        return self.get_episode_data('length', sum)

    def get_episode_returns(self):
        return self.get_episode_data('reward', sum)

    def get_episode_rmse(self):
        return self.get_episode_data('mse', lambda steps: float(np.sqrt(np.mean(steps))))

    def get_episode_constraint_violations(self):
        return self.get_episode_data('constraint_violation', lambda steps: float(any(steps)))

    def get_episode_constraint_violation_steps(self):
        return self.get_episode_data('constraint_violation', sum)
