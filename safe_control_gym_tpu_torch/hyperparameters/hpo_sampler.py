"""The hyperparameter search spaces of PPO, SAC and GP-MPC, and their samplers.

Port of ``safe_control_gym_tpu/hyperparameters/hpo_sampler.py`` (the spaces
come from rl-baselines3-zoo). Each sampler suggests every hyperparameter of
its space through a ``study.Trial``; a non-empty ``hps_dict`` restricts the
space to its keys before anything is suggested.
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ['PPO_dict', 'SAC_dict', 'GPMPC_dict', 'ppo_sampler',
           'sac_sampler', 'gpmpc_sampler', 'HYPERPARAMS_SAMPLER']

PPO_dict = {
    'categorical': {
        'hidden_dim': [8, 16, 32, 64, 128, 256],
        'activation': ['tanh', 'relu'],
        'gamma': [0.9, 0.95, 0.98, 0.99, 0.995, 0.999, 0.9999],
        'gae_lambda': [0.8, 0.9, 0.92, 0.95, 0.98, 0.99, 1.0],
        'clip_param': [0.1, 0.2, 0.3, 0.4],
        'opt_epochs': [1, 5, 10, 20],
        'mini_batch_size': [32, 64, 128],
        'rollout_steps': [50, 100, 150, 200],
        'max_env_steps': [30000, 72000, 216000],
    },
    'float': {
        'target_kl': [1e-8, 0.8],
        'entropy_coef': [1e-8, 0.1],
        'actor_lr': [1e-5, 1],
        'critic_lr': [1e-5, 1],
    },
}

SAC_dict = {
    'categorical': {
        'hidden_dim': [32, 64, 128, 256, 512],
        'activation': ['tanh', 'relu'],
        'gamma': [0.9, 0.95, 0.98, 0.99, 0.995, 0.999, 0.9999],
        'train_interval': [10, 100, 1000],
        'train_batch_size': [32, 64, 128, 256, 512],
        'max_env_steps': [30000, 72000, 216000],
        'warm_up_steps': [500, 1000, 2000, 4000],
    },
    'float': {
        'tau': [0.005, 1.0],
        'actor_lr': [1e-5, 1],
        'critic_lr': [1e-5, 1],
    },
}

GPMPC_dict = {
    'categorical': {
        'horizon': [10, 15, 20, 25, 30, 35],
        'kernel': ['Matern', 'RBF'],
        'n_ind_points': [30, 40, 50],
        'num_epochs': [4, 5, 6, 7, 8],
        'num_samples': [70, 75, 80, 85],
        'optimization_iterations': [200, 300, 400],
    },
    'float': {
        'learning_rate': [5e-4, 0.5],
    },
}


def _sample(space: Dict, trial, hps_dict=None) -> Dict[str, Any]:
    """Suggest each hyperparameter in the space. A non-empty ``hps_dict``
    restricts the search space BEFORE suggesting, so excluded names never
    enter the trial record / TPE history (matching how a restricted
    optuna search space behaves)."""
    out = {}
    for name, choices in space['categorical'].items():
        if hps_dict and name not in hps_dict:
            continue
        out[name] = trial.suggest_categorical(name, choices)
    for name, (low, high) in space['float'].items():
        if hps_dict and name not in hps_dict:
            continue
        out[name] = trial.suggest_float(name, low, high, log=True)
    return out


def ppo_sampler(hps_dict, trial) -> Dict[str, Any]:
    """Sample PPO hyperparameters (hpo_sampler.py:64-135)."""
    return _sample(PPO_dict, trial, hps_dict)


def sac_sampler(hps_dict, trial) -> Dict[str, Any]:
    """Sample SAC hyperparameters (hpo_sampler.py:138-180)."""
    return _sample(SAC_dict, trial, hps_dict)


def gpmpc_sampler(hps_dict, trial) -> Dict[str, Any]:
    """Sample GP-MPC hyperparameters (hpo_sampler.py:183-224)."""
    return _sample(GPMPC_dict, trial, hps_dict)


HYPERPARAMS_SAMPLER = {
    'ppo': ppo_sampler,
    'sac': sac_sampler,
    'gp_mpc': gpmpc_sampler,
}
