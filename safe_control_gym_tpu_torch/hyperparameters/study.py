"""The study: trials, the Random and TPE samplers, the median pruner, shared storage.

Port of ``safe_control_gym_tpu/hyperparameters/study.py``, a copy of its own
(numpy, ``random``, ``fcntl``, no JAX): a ``Trial``/``Study`` ask-tell API with
a Random sampler and a Tree-structured Parzen Estimator (good/bad split of
the finished trials, Parzen densities, the candidate of best density ratio),
``MedianPruner``, single- and multi-objective (Pareto) studies. A study
persists to an embedded SQLite database where ``storage_path`` ends in
``.db`` or ``.sqlite`` (``database.py``), else to an fcntl-locked JSON file;
several processes may share one. Optuna, optional in the JAX package, is not
used: ``HAS_OPTUNA`` only reports whether it imports.

    study = create_study(direction='maximize', sampler='tpe', seed=0)
    study.optimize(lambda t: -(t.suggest_float('x', -2, 2) - 0.7) ** 2, n_trials=20)
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ['Trial', 'TrialPruned', 'Study', 'MedianPruner', 'create_study',
           'HAS_OPTUNA']

try:
    import optuna  # noqa: F401
    HAS_OPTUNA = True
except ImportError:
    HAS_OPTUNA = False


class TrialPruned(Exception):
    """Raised inside an objective to stop a hopeless trial early."""


class MedianPruner:
    """Prune a trial whose intermediate value at step s falls below the
    median of completed trials' intermediate values at the same step
    (optuna.pruners.MedianPruner semantics — the pruner the reference
    configures in hyperparameters/hpo.py:27-60; reporting the
    intermediates, which the reference leaves as a TODO, is real here)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = int(n_startup_trials)
        self.n_warmup_steps = int(n_warmup_steps)

    def should_prune(self, step: int, value: float,
                     history: List[Dict]) -> bool:
        if step < self.n_warmup_steps:
            return False
        done = [t for t in history if t.get('state') == 'COMPLETE']
        if len(done) < self.n_startup_trials:
            return False
        at_step = [t['intermediate'][str(step)] for t in done
                   if str(step) in (t.get('intermediate') or {})]
        if not at_step:
            return False
        # Intermediates are sign-normalized to lower-is-better; prune when
        # the trial is WORSE (larger) than the median at this step.
        return value > float(np.median(at_step))


class Trial:
    """Parameter-suggestion context for one objective evaluation."""

    def __init__(self, number: int, sampler, history: List[Dict],
                 pruner: Optional[MedianPruner] = None, sign=1.0,
                 uid: Optional[str] = None):
        self.number = number
        # Globally unique id, assigned at creation: concurrent workers
        # sharing one study can compute the same `number` between refreshes,
        # so seeds/output dirs must derive from `uid`, never `number`.
        self.uid = uid or uuid.uuid4().hex
        self._sampler = sampler
        self._history = history
        self._pruner = pruner
        self._sign = sign            # -1 when the study maximizes
        self.params: Dict[str, Any] = {}
        self.value: Optional[float] = None
        self.state = 'RUNNING'
        self.intermediate: Dict[str, float] = {}

    def report(self, value: float, step: int):
        """Record an intermediate objective value (internally sign-
        normalized to 'lower is better' like the trial history)."""
        self.intermediate[str(int(step))] = self._sign * float(value)

    def should_prune(self) -> bool:
        if self._pruner is None or not self.intermediate:
            return False
        step = max(int(k) for k in self.intermediate)
        return self._pruner.should_prune(step, self.intermediate[str(step)],
                                         self._history)

    def suggest_categorical(self, name, choices):
        v = self._sampler.sample_categorical(name, list(choices),
                                             self._history)
        self.params[name] = v
        return v

    def suggest_float(self, name, low, high, log=False):
        v = self._sampler.sample_float(name, float(low), float(high), log,
                                       self._history)
        self.params[name] = v
        return v

    def suggest_int(self, name, low, high, log=False):
        v = int(round(self.suggest_float(name, low, high, log=log)))
        self.params[name] = v
        return v


class RandomSampler:
    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def sample_categorical(self, name, choices, history):
        return choices[int(self.rng.integers(len(choices)))]

    def sample_float(self, name, low, high, log, history):
        if log:
            return float(np.exp(self.rng.uniform(np.log(low), np.log(high))))
        return float(self.rng.uniform(low, high))


class TPESampler(RandomSampler):
    """Tree-structured Parzen Estimator: model P(x|good) / P(x|bad) and
    sample the candidate maximizing the ratio."""

    def __init__(self, seed=0, gamma=0.25, n_candidates=24,
                 n_startup_trials=10):
        super().__init__(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup_trials = n_startup_trials

    def _split(self, name, history):
        done = [t for t in history
                if t.get('value') is not None and name in t['params']]
        if len(done) < self.n_startup_trials:
            return None, None
        done.sort(key=lambda t: t['value'])
        n_good = max(1, int(math.ceil(self.gamma * len(done))))
        good = [t['params'][name] for t in done[:n_good]]
        bad = [t['params'][name] for t in done[n_good:]] or good
        return good, bad

    def sample_categorical(self, name, choices, history):
        good, bad = self._split(name, history)
        if good is None:
            return super().sample_categorical(name, choices, history)
        # Laplace-smoothed category weights.
        def weights(vals):
            counts = np.array([sum(1 for v in vals if v == c) + 1.0
                               for c in choices])
            return counts / counts.sum()
        wg, wb = weights(good), weights(bad)
        ratio = wg / wb
        probs = ratio / ratio.sum()
        return choices[int(self.rng.choice(len(choices), p=probs))]

    def sample_float(self, name, low, high, log, history):
        good, bad = self._split(name, history)
        if good is None:
            return super().sample_float(name, low, high, log, history)
        tf = np.log if log else (lambda x: np.asarray(x, float))
        itf = np.exp if log else (lambda x: x)
        lo, hi = float(tf(low)), float(tf(high))
        g = np.asarray(tf(np.asarray(good, float)))
        b = np.asarray(tf(np.asarray(bad, float)))
        bw = max((hi - lo) / max(len(g), 1), 1e-3 * (hi - lo))

        def parzen(x, centers):
            d = (x[:, None] - centers[None, :]) / bw
            return np.exp(-0.5 * d ** 2).sum(axis=1) / max(len(centers), 1)

        # Sample candidates from the good mixture, score by density ratio.
        centers = g[self.rng.integers(len(g), size=self.n_candidates)]
        cands = np.clip(centers + self.rng.normal(0, bw,
                                                  self.n_candidates), lo, hi)
        score = np.log(parzen(cands, g) + 1e-12) - np.log(
            parzen(cands, b) + 1e-12)
        return float(itf(cands[int(np.argmax(score))]))


class Study:
    """Minimal study: sequential ask/tell with JSON persistence."""

    def __init__(self, study_name='study', direction='maximize',
                 sampler=None, storage_path=None, pruner=None):
        self.study_name = study_name
        # Single- OR multi-objective: a str keeps the scalar API; a list of
        # directions makes this a Pareto study (the reference passes
        # ``directions=[...]`` to optuna.create_study, hpo.py:216-230).
        if isinstance(direction, (list, tuple)):
            self.directions = [str(d) for d in direction]
            self.direction = self.directions[0]
        else:
            self.directions = [str(direction)]
            self.direction = str(direction)
        self.sampler = sampler or TPESampler()
        self.pruner = pruner
        self.storage_path = storage_path
        self.trials: List[Dict] = []
        # Storage engine: a *.db / *.sqlite path selects the embedded
        # SQLite database (hyperparameters/database.py — the reference's
        # MySQL-server role); anything else uses fcntl-locked JSON.
        self._store = None
        if storage_path and storage_path.endswith(('.db', '.sqlite')):
            from safe_control_gym_tpu_torch.hyperparameters.database import \
                SqliteTrialStore
            self._store = SqliteTrialStore(storage_path)
            self.trials = self._store.load()
        elif storage_path and os.path.exists(storage_path):
            with open(storage_path) as f:
                self.trials = json.load(f)

    @property
    def n_objectives(self):
        return len(self.directions)

    def _sign(self, v):
        return -v if self.direction == 'maximize' else v

    # -- multi-objective helpers ----------------------------------------
    def _values_of(self, t) -> Optional[List[float]]:
        """Per-objective value vector of a trial record (None if not done)."""
        vs = t.get('values')
        if vs is None and t.get('value') is not None:
            vs = [t['value']]
        return vs

    def _dominates(self, a: List[float], b: List[float]) -> bool:
        """a Pareto-dominates b under this study's directions."""
        at_least_as_good = all(
            (x >= y if d == 'maximize' else x <= y)
            for x, y, d in zip(a, b, self.directions))
        strictly_better = any(
            (x > y if d == 'maximize' else x < y)
            for x, y, d in zip(a, b, self.directions))
        return at_least_as_good and strictly_better

    def _scalar_history_value(self, t, done_values) -> Optional[float]:
        """Lower-is-better scalar the sampler can rank trials by. Scalar
        studies: the signed value. Multi-objective: the trial's domination
        count (how many completed trials Pareto-dominate it) — Pareto-rank
        scalarization, the MO-TPE-lite good/bad split."""
        vs = self._values_of(t)
        if vs is None:
            return None
        if self.n_objectives == 1:
            return self._sign(vs[0])
        return float(sum(self._dominates(o, vs) for o in done_values))

    def ask(self) -> Trial:
        """Create a new trial against the current shared study state
        (optuna's ask/tell API). Pulls other workers' finished trials
        first so the sampler/pruner see the shared history (the
        reference's MySQL storage role, hyperparameters/database.py).
        Multiple asks may be outstanding — a population evaluator asks a
        whole batch before telling any result; uniqueness comes from the
        trial uid, and numbers are re-assigned on merge."""
        self.refresh()
        done_values = [self._values_of(t) for t in self.trials
                       if self._values_of(t) is not None]
        history = [dict(t, value=self._scalar_history_value(t, done_values))
                   for t in self.trials]
        return Trial(len(self.trials), self.sampler, history,
                     pruner=self.pruner,
                     sign=-1.0 if self.direction == 'maximize' else 1.0)

    def tell(self, trial: Trial, value=None, state='COMPLETE'):
        """Record a trial result and persist it."""
        if isinstance(value, (list, tuple)):
            values = [float(v) for v in value]
            scalar = values[0]
        else:
            values = [float(value)] if value is not None else None
            scalar = float(value) if value is not None else None
        self.trials.append({'uid': trial.uid,
                            'number': trial.number,
                            'params': trial.params, 'value': scalar,
                            'values': values,
                            'state': state,
                            'intermediate': trial.intermediate})
        self._persist()

    def optimize(self, objective, n_trials=10, catch=()):
        for _ in range(n_trials):
            trial = self.ask()
            try:
                value = objective(trial)
                state = 'COMPLETE'
            except TrialPruned:
                print(f'[HPO] trial {trial.number} pruned')
                value = None
                state = 'PRUNED'
            except catch as e:
                print(f'[HPO] trial {trial.number} failed: {e}')
                value = None
                state = 'FAIL'
            self.tell(trial, value, state)

    # -- shared JSON storage with file locking --------------------------
    # Multiple worker PROCESSES can share one study: every read/write takes
    # an fcntl lock on a sidecar file and merges trials by uid, replacing
    # the MySQL server the reference coordinates workers through.
    def _locked(self, mode):
        lock_path = self.storage_path + '.lock'
        os.makedirs(os.path.dirname(self.storage_path) or '.', exist_ok=True)
        lf = open(lock_path, 'w')
        fcntl.flock(lf, mode)
        return lf

    def _read_disk(self):
        try:
            with open(self.storage_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return []

    def _merge(self, disk):
        seen = {}
        for t in list(disk) + list(self.trials):
            seen[t.get('uid', f"n{t['number']}")] = t
        merged = list(seen.values())
        for i, t in enumerate(merged):
            t['number'] = i
        self.trials = merged

    def refresh(self):
        """Merge trials other workers persisted since our last sync."""
        if self._store is not None:
            self._merge(self._store.load())
            return
        if not self.storage_path:
            return
        lf = self._locked(fcntl.LOCK_SH)
        try:
            self._merge(self._read_disk())
        finally:
            lf.close()

    def _persist(self):
        if self._store is not None:
            # Atomic upsert-by-uid + read-back: SQLite's own transaction
            # replaces the JSON lock/merge/replace dance.
            self.trials = self._store.merge_write(self.trials)
            return
        if not self.storage_path:
            return
        lf = self._locked(fcntl.LOCK_EX)
        try:
            self._merge(self._read_disk())
            tmp = self.storage_path + '.tmp'
            with open(tmp, 'w') as f:
                json.dump(self.trials, f, indent=1)
            os.replace(tmp, self.storage_path)
        finally:
            lf.close()

    @property
    def best_trial(self):
        done = [t for t in self.trials if t['value'] is not None]
        if not done:
            return None
        key = max if self.direction == 'maximize' else min
        return key(done, key=lambda t: t['value'])

    @property
    def best_params(self):
        bt = self.best_trial
        return bt['params'] if bt else {}

    @property
    def best_value(self):
        bt = self.best_trial
        return bt['value'] if bt else None

    @property
    def best_trials(self):
        """Pareto-optimal completed trials (multi-objective ``best_trials``
        of optuna, reference hpo.py:239-247). For scalar studies this is
        the single best trial in a list."""
        done = [t for t in self.trials if self._values_of(t) is not None]
        if not done:
            return []
        if self.n_objectives == 1:
            return [self.best_trial]
        front = []
        for t in done:
            vt = self._values_of(t)
            if not any(self._dominates(self._values_of(o), vt)
                       for o in done if o is not t):
                front.append(t)
        return front

    def close(self):
        """Release the storage engine (the SQLite connection and its WAL
        sidecars stay open otherwise — one leak per study per worker)."""
        if self._store is not None:
            self._store.close()
            self._store = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def is_better(self, value) -> bool:
        """True when ``value`` improves on the incumbent under this study's
        own direction(s) (so callers never hardcode max/min semantics).
        Multi-objective: true when the candidate vector is not dominated by
        any completed trial."""
        if value is None:
            return False
        if isinstance(value, (list, tuple)):
            vs = [float(v) for v in value]
            done = [self._values_of(t) for t in self.trials
                    if self._values_of(t) is not None]
            return not any(self._dominates(o, vs) for o in done)
        best = self.best_value
        if best is None:
            return True
        return value > best if self.direction == 'maximize' else value < best

    def trials_dataframe(self):
        """Rows of (number, value, state, params...) as list of dicts; a
        multi-objective study adds one ``value_i`` column per objective."""
        rows = []
        for t in self.trials:
            row = dict(number=t['number'], value=t['value'],
                       state=t['state'], **t['params'])
            if self.n_objectives > 1:
                vs = self._values_of(t) or [None] * self.n_objectives
                for i, v in enumerate(vs):
                    row[f'value_{i}'] = v
            rows.append(row)
        return rows


def create_study(study_name='study', direction='maximize', sampler='tpe',
                 seed=0, storage_path=None, pruner=None) -> Study:
    s = (TPESampler(seed=seed) if sampler == 'tpe'
         else RandomSampler(seed=seed))
    return Study(study_name=study_name, direction=direction, sampler=s,
                 storage_path=storage_path, pruner=pruner)
