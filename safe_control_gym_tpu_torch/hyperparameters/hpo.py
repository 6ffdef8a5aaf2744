"""Hyperparameter optimization: a study over repeated train-and-evaluate trials.

Port of ``safe_control_gym_tpu/hyperparameters/hpo.py``. A study (TPE or
Random sampler, ``study.py``) optimizes an algorithm's hyperparameters; a
trial trains the controller ``repetitions`` times and scores the CVaR of its
evaluation returns (``ctrl.run(n_episodes)`` where the controller has it,
else ``BaseExperiment``'s evaluation, as for GP-MPC), with the median
pruner, extra repetitions near the incumbent (``dynamical_runs``),
multi-objective (Pareto) studies over ``MetricExtractor`` metrics, and the
results: ``trials.csv``, ``hyperparameters_<i>.yaml`` (or one
``best_hyperparameters_[...].yaml`` a Pareto trial) and, where matplotlib
is installed, the optimization-history and importance plots. The study
lives in ``output_dir/study.db`` (``database.py``). ``hpo_config:
{vectorized_trials: P}`` scores P trials a round as one population
(``population.py``, PPO only).

Trials train on the card unless the caller passes ``device='cpu'``.

    hpo = HPO('ppo', 'cartpole', output_dir='hpo', task_config=task, algo_config=algo,
              hpo_config={'trials': 10, 'repetitions': 2}, device='cuda')
    study = hpo.hyperparameter_optimization()
"""

from __future__ import annotations

import csv
import os
from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
from safe_control_gym_tpu_torch.hyperparameters.hpo_sampler import \
    HYPERPARAMS_SAMPLER
from safe_control_gym_tpu_torch.hyperparameters.study import (MedianPruner,
                                                        TrialPruned,
                                                        create_study)
from safe_control_gym_tpu_torch.math.metrics import compute_cvar
from safe_control_gym_tpu_torch.utils import yaml_io
from safe_control_gym_tpu_torch.utils.device import resolve_device
from safe_control_gym_tpu_torch.utils.registration import get_config, make

__all__ = ['HPO']


class HPO:
    """Hyperparameter optimization harness."""

    def __init__(self, algo, task, sampler='tpe', output_dir='./hpo',
                 task_config=None, hpo_config=None, algo_config=None,
                 device='cuda', **kwargs):
        self.algo = algo
        self.task = task
        self.output_dir = output_dir
        self.device = resolve_device(device)
        self.task_config = dict(task_config or {})
        # Registry defaults under the caller's algo overrides (an id with no
        # registry entry, as a test's sampler may use, has none).
        try:
            self.algo_config = get_config(algo)
        except KeyError:
            self.algo_config = {}
        self.algo_config.update(algo_config or {})
        self.hpo_config = dict(hpo_config or {})
        self.n_trials = int(self.hpo_config.get('trials', 20))
        self.n_repetitions = int(self.hpo_config.get('repetitions', 2))
        self.n_episodes = int(self.hpo_config.get('n_episodes', 5))
        self.cvar_alpha = float(self.hpo_config.get('alpha', 0.5))
        self.hps_config = self.hpo_config.get('hps_config', {})
        # Pruning + adaptive repetitions (reference hpo.py:27-60 configures
        # a MedianPruner; :149-158 adds dynamical extra runs near the
        # incumbent to fight maximization bias).
        self.use_pruner = bool(self.hpo_config.get('prune', True))
        self.dynamical_runs = bool(self.hpo_config.get('dynamical_runs',
                                                       False))
        self.warm_trials = int(self.hpo_config.get('warm_trials', 5))
        self.approximation_threshold = float(
            self.hpo_config.get('approximation_threshold', 5.0))
        self.max_extra_repetitions = int(
            self.hpo_config.get('max_extra_repetitions', 4))
        # Objective/direction lists (reference hpo.py:59 asserts equal
        # length; a list of len > 1 makes this a Pareto study,
        # hpo.py:216-230). 'return' = CVaR over raw episode returns (the
        # native fast path); any other name is a MetricExtractor metric key
        # evaluated per repetition (the reference's
        # ``metrics[objective[0]]``, hpo.py:139).
        # Population-batched trial evaluation (hyperparameters/population.py):
        # vectorized_trials=B scores B trials per round in ONE vmapped
        # device program. PPO + scalar 'return' objective only; pruning
        # does not apply (no per-repetition host round-trips to prune at).
        self.vectorized_trials = int(self.hpo_config.get('vectorized_trials',
                                                         0))
        obj = self.hpo_config.get('objective', ['return'])
        dirs = self.hpo_config.get('direction', ['maximize'])
        self.objectives = [obj] if isinstance(obj, str) else list(obj)
        self.directions = [dirs] if isinstance(dirs, str) else list(dirs)
        assert len(self.objectives) == len(self.directions), \
            'objective and direction must have the same length'
        os.makedirs(output_dir, exist_ok=True)
        if len(self.objectives) > 1:
            # Median pruning is undefined on a Pareto front (optuna raises
            # on report() in MO studies); disable it like the reference's
            # MO configs effectively do.
            self.use_pruner = False
        pruner = (MedianPruner(
            n_startup_trials=int(self.hpo_config.get('pruner_startup_trials',
                                                     5)),
            n_warmup_steps=int(self.hpo_config.get('pruner_warmup_steps', 0)))
            if self.use_pruner else None)
        self.study = create_study(
            study_name=f'{algo}_hpo',
            direction=(self.directions if len(self.directions) > 1
                       else self.directions[0]),
            sampler=sampler,
            seed=int(self.hpo_config.get('seed', 0)),
            # Default storage is the embedded SQLite study database
            # (hyperparameters/database.py, the reference's MySQL role);
            # set storage: <path>.json for the locked-JSON backend.
            storage_path=self.hpo_config.get(
                'storage', os.path.join(output_dir, 'study.db')),
            pruner=pruner)

    # ------------------------------------------------------------------
    def _build_trial_controller(self, trial, rep):
        """Shared trial setup: env factory + trained controller.

        Seeds and output dirs derive from the trial's globally unique
        uid, not its locally computed number: concurrent workers sharing
        one study can race to the same number between refreshes, which
        would duplicate seeds and clobber each other's trial dirs."""
        seed = 1000 * (int(trial.uid[:8], 16) % 100_000 + 1) + rep
        env_func = partial(make, self.task, seed=seed, device=self.device,
                           **self.task_config)
        cfg = {**self.algo_config, **self._suggestion}
        ctrl = make(self.algo, env_func, seed=seed,
                    output_dir=os.path.join(
                        self.output_dir,
                        f'trial_{trial.number}_{trial.uid[:8]}'),
                    **cfg)
        if hasattr(ctrl, 'reset'):
            ctrl.reset()
        ctrl.learn()
        return env_func, ctrl

    def _one_repetition(self, trial, rep) -> list:
        """Train + evaluate once; returns the episode-return list."""
        env_func, ctrl = self._build_trial_controller(trial, rep)
        # RL controllers expose the fast batched self-eval run(n_episodes);
        # MPC-family run() is the reference's single-episode signature
        # (run(env, ...)) — evaluate those through BaseExperiment, which
        # yields per-episode returns for the CVaR tail either way.
        import inspect
        run = getattr(ctrl, 'run', None)
        if (run is not None
                and 'n_episodes' in inspect.signature(run).parameters):
            res = run(n_episodes=self.n_episodes)
            out = np.asarray(res['ep_returns']).tolist()
            ctrl.close()
        else:
            exp = BaseExperiment(env_func(), ctrl)
            exp.run_evaluation(n_episodes=self.n_episodes, verbose=False)
            out = [float(r) for r in
                   exp.metric_extractor.get_episode_returns()]
            exp.close()  # closes ctrl and both envs
        return out

    def _one_repetition_metrics(self, trial, rep) -> dict:
        """Train + evaluate once, returning the full MetricExtractor dict
        (the reference's per-repetition ``metrics[objective]`` source,
        hpo.py:136-139). Used whenever the objective list names metric
        keys instead of the raw-'return' fast path."""
        env_func, ctrl = self._build_trial_controller(trial, rep)
        exp = BaseExperiment(env_func(), ctrl)
        _, metrics = exp.run_evaluation(n_episodes=self.n_episodes,
                                        verbose=False)
        exp.close()
        return metrics

    def objective(self, trial):
        """One trial: repeated train+eval, per-objective CVaR scores,
        per-repetition pruning reports, and extra repetitions near the
        incumbent (hpo.py:111-158). Scalar studies return a float;
        multi-objective studies return the per-objective score list
        (hpo.py:216-230)."""
        sampler_fn = HYPERPARAMS_SAMPLER[self.algo]
        self._suggestion = sampler_fn(self.hps_config, trial)
        multi = len(self.objectives) > 1
        metric_mode = self.objectives != ['return']
        samples = {n: [] for n in self.objectives}

        def _collect(rep):
            if metric_mode:
                metrics = self._one_repetition_metrics(trial, rep)
                for n in self.objectives:
                    # 'return' in a metric-mode list aliases the
                    # MetricExtractor key (compute_metrics emits
                    # 'average_return', never 'return').
                    key = 'average_return' if n == 'return' else n
                    samples[n].append(float(metrics[key]))
            else:
                samples['return'].extend(self._one_repetition(trial, rep))

        def _scores():
            # Risk-sensitive per objective: CVaR of the WORST tail under
            # that objective's own direction (lower tail when maximizing,
            # upper tail when minimizing).
            return [float(compute_cvar(np.asarray(samples[n]),
                                       self.cvar_alpha,
                                       lower_range=(d == 'maximize')))
                    for n, d in zip(self.objectives, self.directions)]

        scores = [0.0] * len(self.objectives)
        try:
            for rep in range(self.n_repetitions):
                _collect(rep)
                scores = _scores()
                # Real intermediate reporting (the reference leaves this as
                # a TODO next to its MedianPruner, hpo.py:116).
                trial.report(scores[0], step=rep)
                if (not multi and rep + 1 < self.n_repetitions
                        and trial.should_prune()):
                    raise TrialPruned()
            # Extra repetitions near the incumbent: better-than-best trials
            # get more runs until the CVaR estimate stabilizes
            # (hpo.py:149-158 'dynamical runs'; scalar studies only, like
            # the reference).
            if (not multi and self.dynamical_runs
                    and len(self.study.trials) >= self.warm_trials
                    and self.study.is_better(scores[0])):
                rep = self.n_repetitions
                while rep < self.n_repetitions + self.max_extra_repetitions:
                    _collect(rep)
                    new_scores = _scores()
                    trial.report(new_scores[0], step=rep)
                    stable = abs(new_scores[0] - scores[0]) <= \
                        self.approximation_threshold
                    scores = new_scores
                    rep += 1
                    if stable:
                        break
        except TrialPruned:
            raise
        except Exception as e:
            # Crashed trials score the WORST value under each objective's
            # direction (the reference's 0.0 sentinel, hpo.py:111-133, is
            # only safe for its maximize-only studies — with 'minimize'
            # a 0.0 crash would rank as the best possible trial).
            print(f'[HPO] trial crashed: {e}')
            worst = [float('-inf') if d == 'maximize' else float('inf')
                     for d in self.directions]
            return worst if multi else worst[0]
        return scores if multi else scores[0]

    # ------------------------------------------------------------------
    def _optimize_vectorized(self):
        """TPE ask/tell in rounds of ``vectorized_trials`` trials, each round
        trained and evaluated as one population (``population.py``: one
        K1/K2/K3 launch a step for all its envs). Lanes are trial-major, R
        repetition lanes a trial, each seeded from the trial's uid (+rep); a
        trial's score is the CVaR over its R x n_episodes returns, as in the
        sequential 'return' path. Trials of a round see only earlier rounds'
        history. Structural hyperparameters (hidden_dim, rollout_steps, ...)
        shape the population, so a round's trials are grouped by them:
        restrict ``hps_config`` to ``VECTOR_HPS`` to keep a round one
        population."""
        import time as _time

        from safe_control_gym_tpu_torch.hyperparameters.population import (
            VECTOR_HPS, make_population_ppo_evaluator, split_suggestion)
        assert self.algo == 'ppo', \
            'vectorized_trials currently implements PPO'
        assert self.objectives == ['return'] and len(self.directions) == 1, \
            'vectorized_trials requires the scalar return objective'
        sampler_fn = HYPERPARAMS_SAMPLER[self.algo]
        env_func = partial(make, self.task, seed=0, **self.task_config)
        evaluators = {}
        R = max(1, self.n_repetitions)
        remaining = self.n_trials
        self.vectorized_rounds = []
        while remaining > 0:
            b = min(self.vectorized_trials, remaining)
            remaining -= b
            trials = [self.study.ask() for _ in range(b)]
            groups = {}
            for t in trials:
                vec, struct = split_suggestion(sampler_fn(self.hps_config, t))
                groups.setdefault(tuple(sorted(struct.items())), []).append((t, vec))
            for skey, members in groups.items():
                cfg = {**self.algo_config, **dict(skey)}
                N = max(1, int(cfg.get('rollout_batch_size', 32)))
                T = max(1, int(cfg.get('rollout_steps', 64)))
                iters = max(1, int(cfg.get('max_env_steps', 50_000)) // (N * T))
                ekey = (N, T, iters, int(cfg.get('opt_epochs', 10)),
                        int(cfg.get('mini_batch_size', 64)),
                        int(cfg.get('hidden_dim', 64)),
                        str(cfg.get('activation', 'tanh')),
                        bool(cfg.get('use_gae', False)))
                if ekey not in evaluators:
                    evaluators[ekey] = make_population_ppo_evaluator(
                        env_func, rollout_batch_size=N, rollout_steps=T,
                        iterations=iters, opt_epochs=ekey[3],
                        mini_batch_size=ekey[4], hidden_dim=ekey[5],
                        activation=ekey[6], use_gae=ekey[7],
                        n_eval=self.n_episodes, device=self.device)
                evaluate = evaluators[ekey]
                hp_arrays = {
                    name: np.repeat([float(vec.get(
                        name, self.algo_config.get(name, np.nan)))
                        for _, vec in members], R)
                    for name in VECTOR_HPS
                    if any(name in vec or name in self.algo_config
                           for _, vec in members)}
                seeds = [1000 * (int(t.uid[:8], 16) % 100_000 + 1) + rep
                         for t, _ in members for rep in range(R)]
                t0 = _time.perf_counter()
                returns = evaluate(hp_arrays, seeds)
                wall = _time.perf_counter() - t0
                self.vectorized_rounds.append({'trials': len(members), 'lanes': len(seeds),
                                               'seconds': wall})
                print(f'[HPO] vectorized round: {len(members)} trials x '
                      f'{R} reps ({returns.shape[0]} lanes, '
                      f'{evaluate.env_steps_per_lane} env steps each) '
                      f'as one population, {wall:.1f} s')
                per_trial = returns.reshape(len(members), R * returns.shape[-1])
                for (t, _), samples in zip(members, per_trial):
                    score = float(compute_cvar(
                        samples, self.cvar_alpha,
                        lower_range=(self.directions[0] == 'maximize')))
                    if not np.isfinite(score):
                        # Diverged lanes score the worst value, like
                        # crashed sequential trials.
                        score = (float('-inf')
                                 if self.directions[0] == 'maximize'
                                 else float('inf'))
                    t.report(score, step=0)
                    self.study.tell(t, score)

    def hyperparameter_optimization(self):
        """Run the study + dump artifacts (hpo.py:160-264)."""
        if self.vectorized_trials > 1:
            self._optimize_vectorized()
        else:
            self.study.optimize(self.objective, n_trials=self.n_trials,
                                catch=(Exception,))
        self.save_results()
        return self.study

    def close(self):
        """Release the study's storage engine (SQLite connection)."""
        self.study.close()

    def save_results(self, top_n: int = 3):
        """trials.csv + best-hyperparameter YAMLs + importance/history
        plots (hpo.py:211-264). Scalar study: top-n YAMLs by value.
        Multi-objective: one YAML per Pareto-optimal trial, named by its
        objective vector like the reference's
        ``best_hyperparameters_[v0,v1].yaml`` (hpo.py:239-247)."""
        rows = self.study.trials_dataframe()
        if not rows:
            return
        keys = sorted({k for r in rows for k in r})
        with open(os.path.join(self.output_dir, 'trials.csv'), 'w',
                  newline='') as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for r in rows:
                w.writerow(r)
        if len(self.objectives) > 1:
            for t in self.study.best_trials:
                vs = self.study._values_of(t)
                tag = ','.join(f'{v:.4f}' for v in vs)
                with open(os.path.join(
                        self.output_dir,
                        f'best_hyperparameters_[{tag}].yaml'), 'w') as f:
                    yaml_io.dump(dict(t['params']), f)
        else:
            done = [r for r in rows if r.get('value') is not None]
            done.sort(key=lambda r: r['value'],
                      reverse=(self.directions[0] == 'maximize'))
            for i, r in enumerate(done[:top_n]):
                params = {k: v for k, v in r.items()
                          if k not in ('number', 'value', 'state')}
                with open(os.path.join(
                        self.output_dir,
                        f'hyperparameters_{i}.yaml'), 'w') as f:
                    yaml_io.dump(params, f)
        try:
            self.save_plots()
        except ImportError as e:  # no matplotlib: the results stand without plots
            print(f'[HPO] plots skipped: {e}')

    # -- study visualization -------------------------------------------
    def _param_importances(self, trials, values):
        """Correlation-based importance (fANOVA-lite): |rank correlation|
        between each hyperparameter and the objective, normalized to sum
        to 1 — the role of optuna.importance in the reference's
        ``plot_param_importances`` (hpo.py:237-244)."""
        names = sorted({k for t in trials for k in t['params']})
        v = np.asarray(values, float)
        imps = {}
        for name in names:
            xs, ys = [], []
            for t, val in zip(trials, values):
                if name in t['params']:
                    xs.append(t['params'][name])
                    ys.append(val)
            if len(xs) < 3:
                imps[name] = 0.0
                continue
            ys = np.asarray(ys, float)
            try:
                x_num = np.asarray(xs, float)
            except (TypeError, ValueError):
                # Categorical: encode each category by its group mean.
                cats = {c: np.mean([y for x, y in zip(xs, ys) if x == c])
                        for c in set(xs)}
                x_num = np.asarray([cats[x] for x in xs], float)
            if np.std(x_num) == 0 or np.std(ys) == 0:
                imps[name] = 0.0
                continue
            rx = np.argsort(np.argsort(x_num)).astype(float)
            ry = np.argsort(np.argsort(ys)).astype(float)
            imps[name] = float(abs(np.corrcoef(rx, ry)[0, 1]))
        total = sum(imps.values())
        if total > 0:
            imps = {k: v / total for k, v in imps.items()}
        return imps

    def save_plots(self):
        """``param_importances.png`` + ``optimization_history.png`` per
        study — per objective for multi-objective studies, matching the
        reference's file naming (hpo.py:237-262)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        trials = [t for t in self.study.trials
                  if self.study._values_of(t) is not None
                  and np.isfinite(self.study._values_of(t)).all()]
        if not trials:
            return
        multi = len(self.objectives) > 1
        for i, (name, direction) in enumerate(zip(self.objectives,
                                                  self.directions)):
            suffix = f'_{name}' if multi else ''
            values = [self.study._values_of(t)[i] for t in trials]
            numbers = [t['number'] for t in trials]
            # Optimization history: per-trial objective + running best.
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.scatter(numbers, values, s=18, label='trial value')
            best_fn = np.maximum if direction == 'maximize' else np.minimum
            ax.plot(numbers, best_fn.accumulate(values), color='tab:red',
                    label='best value')
            ax.set_xlabel('trial')
            ax.set_ylabel(name if multi else 'objective value')
            ax.set_title(f'Optimization history ({direction})')
            ax.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(self.output_dir,
                                     f'optimization_history{suffix}.png'))
            plt.close(fig)
            # Parameter importances.
            imps = self._param_importances(trials, values)
            if imps:
                order = sorted(imps, key=imps.get)
                fig, ax = plt.subplots(
                    figsize=(6, 0.5 + 0.35 * len(order)))
                ax.barh(order, [imps[k] for k in order])
                ax.set_xlabel('importance (normalized |rank corr|)')
                ax.set_title(f'Hyperparameter importances'
                             f'{" — " + name if multi else ""}')
                fig.tight_layout()
                fig.savefig(os.path.join(
                    self.output_dir, f'param_importances{suffix}.png'))
                plt.close(fig)

    def checkpoint(self):
        self.study._persist()
