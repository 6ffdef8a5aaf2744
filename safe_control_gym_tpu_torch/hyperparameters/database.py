"""The study database: trials shared by worker processes through an embedded SQLite file.

Port of ``safe_control_gym_tpu/hyperparameters/database.py``, a copy of its
own (``sqlite3``, no JAX). ``SqliteTrialStore`` upserts trials by their unique
uid inside one IMMEDIATE transaction (WAL journal, busy timeout), so several
processes can work on one ``study.db``; ``create``/``drop`` make and remove a
study's database under ``./hpo_storage/<tag>_hpo/``, and ``backup``/``restore``
dump it to portable SQL text and rebuild it. ``python -m
safe_control_gym_tpu_torch.hyperparameters.database --func create --tag ppo``
runs one of them.
"""

from __future__ import annotations

import json
import os
import shutil
import sqlite3
from typing import Dict, List, Optional

__all__ = ['SqliteTrialStore', 'create', 'drop', 'backup', 'restore',
           'study_db_path']

_SCHEMA = """
CREATE TABLE IF NOT EXISTS trials (
    uid          TEXT PRIMARY KEY,
    number       INTEGER NOT NULL,
    params       TEXT NOT NULL,
    value        REAL,
    vals         TEXT,
    state        TEXT NOT NULL,
    intermediate TEXT,
    created_at   TEXT NOT NULL DEFAULT (datetime('now'))
);
CREATE TABLE IF NOT EXISTS study_meta (
    key   TEXT PRIMARY KEY,
    value TEXT
);
"""


class SqliteTrialStore:
    """Shared trial storage for one study, safe across processes.

    Concurrency model: SQLite's own file locking replaces both the
    reference's MySQL server and the JSON backend's fcntl sidecar lock.
    WAL mode lets readers (``load`` — other workers polling the study)
    proceed while a writer commits; ``busy_timeout`` makes concurrent
    writers queue instead of erroring.
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._con = sqlite3.connect(path, timeout=30.0)
        self._con.execute('PRAGMA journal_mode=WAL')
        self._con.execute('PRAGMA busy_timeout=30000')
        self._con.execute('PRAGMA synchronous=NORMAL')
        with self._con:
            self._con.executescript(_SCHEMA)

    # -- trial records --------------------------------------------------
    @staticmethod
    def _row_to_trial(row) -> Dict:
        uid, number, params, value, vals, state, intermediate = row
        return {'uid': uid, 'number': number,
                'params': json.loads(params), 'value': value,
                'values': json.loads(vals) if vals else None,
                'state': state,
                'intermediate': json.loads(intermediate)
                if intermediate else {}}

    def load(self) -> List[Dict]:
        """All trials, in insertion order, renumbered densely (the same
        merged view every worker sees)."""
        rows = self._con.execute(
            'SELECT uid, number, params, value, vals, state, intermediate '
            'FROM trials ORDER BY rowid').fetchall()
        out = [self._row_to_trial(r) for r in rows]
        for i, t in enumerate(out):
            t['number'] = i
        return out

    def merge_write(self, trials: List[Dict]) -> List[Dict]:
        """Upsert ``trials`` by uid in one IMMEDIATE transaction and return
        the merged, renumbered study (disk ∪ ours) — one atomic step, the
        role of the JSON backend's lock/merge/replace dance."""
        with self._con:
            self._con.execute('BEGIN IMMEDIATE')
            for t in trials:
                self._con.execute(
                    'INSERT INTO trials '
                    '(uid, number, params, value, vals, state, intermediate)'
                    ' VALUES (?, ?, ?, ?, ?, ?, ?) '
                    'ON CONFLICT(uid) DO UPDATE SET '
                    'number=excluded.number, params=excluded.params, '
                    'value=excluded.value, vals=excluded.vals, '
                    'state=excluded.state, '
                    'intermediate=excluded.intermediate',
                    (t.get('uid', f"n{t['number']}"), int(t['number']),
                     json.dumps(t.get('params', {})), t.get('value'),
                     json.dumps(t['values']) if t.get('values') is not None
                     else None,
                     t.get('state', 'COMPLETE'),
                     json.dumps(t.get('intermediate') or {})))
        return self.load()

    def set_meta(self, key: str, value: str):
        with self._con:
            self._con.execute(
                'INSERT INTO study_meta (key, value) VALUES (?, ?) '
                'ON CONFLICT(key) DO UPDATE SET value=excluded.value',
                (key, str(value)))

    def get_meta(self, key: str) -> Optional[str]:
        row = self._con.execute(
            'SELECT value FROM study_meta WHERE key=?', (key,)).fetchone()
        return row[0] if row else None

    def close(self):
        self._con.close()


# ----------------------------------------------------------------------
# Module-level helpers named after the reference's create/drop CLI
# (database.py:10-40). Studies live under ./hpo_storage/<tag>_hpo/study.db.
# ----------------------------------------------------------------------
def _study_dir(config_or_name) -> str:
    if isinstance(config_or_name, str):
        name = config_or_name
    else:
        name = getattr(config_or_name, 'tag', None) or \
            config_or_name.get('tag', 'study')
    return os.path.join('./hpo_storage', f'{name}_hpo')


def study_db_path(config_or_name) -> str:
    return os.path.join(_study_dir(config_or_name), 'study.db')


def create(config_or_name) -> str:
    """Create the study database named after the tag; returns the study
    directory (CREATE DATABASE IF NOT EXISTS role, database.py:10-21)."""
    path = _study_dir(config_or_name)
    os.makedirs(path, exist_ok=True)
    SqliteTrialStore(os.path.join(path, 'study.db')).close()
    return path


def drop(config_or_name) -> None:
    """Remove the study database and its directory (DROP DATABASE role,
    database.py:23-40). Back up first — see ``backup``."""
    path = _study_dir(config_or_name)
    if os.path.isdir(path):
        shutil.rmtree(path)


def backup(config_or_name, dest: Optional[str] = None) -> str:
    """Dump the study database to portable SQL text — the mysqldump recipe
    the reference documents (database.py:26-27). Returns the dump path."""
    db = study_db_path(config_or_name)
    # Default dump lands BESIDE the study directory (not inside it) so a
    # subsequent drop() leaves the backup intact — like mysqldump to cwd.
    sdir = _study_dir(config_or_name)
    dest = dest or os.path.join(os.path.dirname(sdir),
                                os.path.basename(sdir) + '.sql')
    con = sqlite3.connect(db)
    try:
        with open(dest, 'w') as f:
            for line in con.iterdump():
                f.write(line + '\n')
    finally:
        con.close()
    return dest


def restore(src: str, config_or_name) -> str:
    """Recreate a study database from a SQL dump (the reference's
    'create database; mysql < dump.sql' recipe, database.py:28-30)."""
    path = _study_dir(config_or_name)
    os.makedirs(path, exist_ok=True)
    db = os.path.join(path, 'study.db')
    if os.path.exists(db):
        os.remove(db)
    con = sqlite3.connect(db)
    try:
        with open(src) as f:
            con.executescript(f.read())
        con.commit()
    finally:
        con.close()
    return db


MAIN_FUNCS = {'create': create, 'drop': drop, 'backup': backup,
              'restore': restore}

if __name__ == '__main__':
    from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
    fac = ConfigFactory()
    fac.add_argument('--func', type=str, default='create',
                     help='create | drop | backup | restore')
    fac.add_argument('--src', type=str, default=None,
                     help='SQL dump to restore from (restore only)')
    config = fac.merge()
    # merge() keeps only the base arguments: read --func and --src directly.
    args, _ = fac.parser.parse_known_args()
    func = MAIN_FUNCS.get(args.func)
    if func is None:
        raise ValueError(f'Main function {args.func} not supported.')
    if args.func == 'restore':
        func(args.src, config)
    else:
        func(config)
