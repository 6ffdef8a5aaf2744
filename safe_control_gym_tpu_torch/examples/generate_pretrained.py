"""Train the pretrained models the examples load, in the port's checkpoint format.

Port of ``examples/generate_pretrained.py``: the same jobs (the RL models of
``examples/rl/models``, the SafeExplorer models, the MPSC RPI sets and RL
policies of ``examples/mpsc/models``, the CBF-NN), from the examples' own
YAML. The files go under ``--out_dir`` in the ``examples/`` tree's layout
(``rl/models/<algo>/<algo>_model_<system>_<task>.pt``, ``mpsc/models/...``,
``cbf/models/...``), written by ``utils/checkpoint.save_checkpoint``; the
default is ``pretrained/`` at the repository's root, which git ignores. It
never writes into ``examples/*/models/``: those hold the JAX package's
committed files, which both packages' tests load. The training runs' logs go
under ``<out_dir>/runs/<job>``.

    python -m safe_control_gym_tpu_torch.examples.generate_pretrained [--steps 45000] \\
        [--only JOB ...] [--out_dir DIR] [--device cpu]
    python -m safe_control_gym_tpu_torch.examples.rl.rl_experiment ... --kv_overrides ... \\
        # then load with run(curr_path=DIR/rl)

``--tpu_scale`` is accepted as in the JAX package, where it changes nothing:
the large quadrotor jobs always take the large-batch settings (``LARGE``).
"""

import argparse
import os
from functools import partial

from safe_control_gym_tpu_torch.examples import EXAMPLES_DIR, example_dir
from safe_control_gym_tpu_torch.utils import yaml_io
from safe_control_gym_tpu_torch.utils.registration import get_config, make

DEFAULT_OUT_DIR = os.path.join(os.path.dirname(EXAMPLES_DIR), 'pretrained')

# The large-batch settings of the committed quadrotor tracking and 3D models.
LARGE = {'ppo': dict(rollout_batch_size=256, rollout_steps=128, mini_batch_size=4096,
                     fused_iterations=8),
         'sac': dict(rollout_batch_size=32, train_interval=320, train_batch_size=512,
                     warm_up_steps=5000, max_buffer_size=400000, fused_iterations=8)}


def _load_yaml(*parts):
    return yaml_io.load_file(example_dir(*parts))


def _train_and_save(algo, env_func, algo_cfg, job, out_dir, path):
    ctrl = make(algo, env_func, training=True, seed=0,
                output_dir=os.path.join(out_dir, 'runs', job), **algo_cfg)
    ctrl.learn()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ctrl.save(path)
    ctrl.close()
    print(f'{job}: saved {path}')
    return path


def train_rl(algo, steps, sysdir='cartpole', system='cartpole', task='stab', large=False,
             out_dir=DEFAULT_OUT_DIR, device='cuda'):
    """An RL model of ``examples/rl``: the registry's config under the
    example's overrides, ``steps`` env steps."""
    task_cfg = _load_yaml('rl', 'config_overrides', sysdir, f'{sysdir}_{task}.yaml')['task_config']
    algo_cfg = get_config(algo)
    algo_cfg.update(_load_yaml('rl', 'config_overrides', sysdir,
                               f'{algo}_{sysdir}.yaml')['algo_config'])
    algo_cfg['max_env_steps'] = steps
    if large:
        algo_cfg.update(LARGE[algo])
    return _train_and_save(
        algo, partial(make, system, device=device, **task_cfg), algo_cfg,
        f'{algo}_{sysdir}_{task}', out_dir,
        os.path.join(out_dir, 'rl', 'models', algo, f'{algo}_model_{sysdir}_{task}.pt'))


def train_mpsc_rl(algo, steps, sysdir='cartpole', system='cartpole', task='stab',
                  out_dir=DEFAULT_OUT_DIR, device='cuda'):
    """An RL policy the MPSC example certifies."""
    task_cfg = _load_yaml('mpsc', 'config_overrides', sysdir,
                          f'{sysdir}_{task}.yaml')['task_config']
    algo_cfg = get_config(algo)
    algo_cfg.update(_load_yaml('mpsc', 'config_overrides', sysdir,
                               f'{algo}_{sysdir}.yaml')['algo_config'])
    algo_cfg['max_env_steps'] = steps
    return _train_and_save(
        algo, partial(make, system, device=device, **task_cfg), algo_cfg,
        f'mpsc_{algo}_{sysdir}_{task}', out_dir,
        os.path.join(out_dir, 'mpsc', 'models', f'{algo}_model_{sysdir}_{task}.pt'))


def learn_mpsc(sysdir='cartpole', system='cartpole', out_dir=DEFAULT_OUT_DIR, device='cuda'):
    """The linear MPSC filter's RPI set of a system."""
    task_cfg = _load_yaml('mpsc', 'config_overrides', sysdir,
                          f'{sysdir}_stab.yaml')['task_config']
    sf_cfg = get_config('linear_mpsc')
    sf_cfg.update(_load_yaml('mpsc', 'config_overrides', sysdir,
                             f'linear_mpsc_{sysdir}.yaml')['sf_config'])
    sf = make('linear_mpsc', partial(make, system, device=device, **task_cfg), **sf_cfg)
    sf.learn()
    path = os.path.join(out_dir, 'mpsc', 'models', f'linear_mpsc_{sysdir}.pkl')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sf.save(path)
    print(f'mpsc/{sysdir}: saved {path}')
    return path


def train_safe_explorer(steps, sysdir='cartpole', system='cartpole', task='stab',
                        out_dir=DEFAULT_OUT_DIR, device='cuda'):
    """A SafeExplorerPPO model: 3 constraint epochs of 1000 steps, then PPO."""
    spec = _load_yaml('rl', 'config_overrides', sysdir, f'safe_explorer_ppo_{sysdir}.yaml')
    task_cfg = _load_yaml('rl', 'config_overrides', sysdir, f'{sysdir}_{task}.yaml')['task_config']
    task_cfg.update(spec.get('task_config', {}))
    cfg = get_config('safe_explorer_ppo')
    cfg.update(spec['algo_config'])
    cfg.update(max_env_steps=steps, constraint_steps_per_epoch=1000, constraint_epochs=3)
    return _train_and_save(
        'safe_explorer_ppo', partial(make, system, device=device, **task_cfg), cfg,
        f'se_{sysdir}_{task}', out_dir,
        os.path.join(out_dir, 'rl', 'models', 'safe_explorer_ppo',
                     f'safe_explorer_ppo_model_{sysdir}_{task}.pt'))


def learn_cbf_nn(out_dir=DEFAULT_OUT_DIR, device='cuda'):
    """The CBF-NN filter of the cartpole (5 episodes, 100 training iterations)."""
    task_cfg = _load_yaml('cbf', 'config_overrides', 'cartpole',
                          'cartpole_stab.yaml')['task_config']
    sf_cfg = get_config('cbf_nn')
    sf_cfg.update(num_episodes=5, train_iterations=100)
    sf = make('cbf_nn', partial(make, 'cartpole', device=device, **task_cfg), **sf_cfg)
    sf.learn()
    path = os.path.join(out_dir, 'cbf', 'models', 'cbf_nn_cartpole.pt')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sf.save(path)
    print(f'cbf_nn: saved {path}')
    return path


def jobs(steps=45000, out_dir=DEFAULT_OUT_DIR, device='cuda'):
    """Every job by name, as in the JAX package's script."""
    kw = dict(out_dir=out_dir, device=device)
    q2, q3 = dict(sysdir='quadrotor_2D', system='quadrotor'), dict(sysdir='quadrotor_3D',
                                                                  system='quadrotor')
    return {
        # RL models (rl/models).
        'ppo_cartpole_stab': lambda: train_rl('ppo', steps, **kw),
        'ppo_cartpole_track': lambda: train_rl('ppo', steps, task='track', **kw),
        'sac_cartpole_stab': lambda: train_rl('sac', steps // 2, **kw),
        'sac_cartpole_track': lambda: train_rl('sac', steps // 2, task='track', **kw),
        'ppo_quadrotor_2D_stab': lambda: train_rl('ppo', steps, **q2, **kw),
        'sac_quadrotor_2D_stab': lambda: train_rl('sac', steps // 2, **q2, **kw),
        'ppo_quadrotor_2D_track': lambda: train_rl('ppo', 6_000_000, task='track', large=True,
                                                   **q2, **kw),
        'sac_quadrotor_2D_track': lambda: train_rl('sac', 1_500_000, task='track', large=True,
                                                   **q2, **kw),
        'ppo_quadrotor_3D_stab': lambda: train_rl('ppo', 2_000_000, large=True, **q3, **kw),
        'sac_quadrotor_3D_stab': lambda: train_rl('sac', 1_500_000, large=True, **q3, **kw),
        'ppo_quadrotor_3D_track': lambda: train_rl('ppo', 6_000_000, task='track', large=True,
                                                   **q3, **kw),
        'sac_quadrotor_3D_track': lambda: train_rl('sac', 1_500_000, task='track', large=True,
                                                   **q3, **kw),
        # SafeExplorer models.
        'se_cartpole_stab': lambda: train_safe_explorer(steps // 2, **kw),
        'se_cartpole_track': lambda: train_safe_explorer(steps // 2, task='track', **kw),
        'se_quadrotor_2D_stab': lambda: train_safe_explorer(steps // 2, **q2, **kw),
        'se_quadrotor_2D_track': lambda: train_safe_explorer(steps // 2, task='track', **q2,
                                                             **kw),
        'se_quadrotor_3D_stab': lambda: train_safe_explorer(steps // 2, **q3, **kw),
        'se_quadrotor_3D_track': lambda: train_safe_explorer(steps // 2, task='track', **q3,
                                                             **kw),
        # MPSC (mpsc/models).
        'mpsc_rpi_cartpole': lambda: learn_mpsc(**kw),
        'mpsc_rpi_quadrotor_2D': lambda: learn_mpsc(**q2, **kw),
        'mpsc_ppo_cartpole_stab': lambda: train_mpsc_rl('ppo', steps // 2, **kw),
        'mpsc_ppo_cartpole_track': lambda: train_mpsc_rl('ppo', steps // 2, task='track', **kw),
        'mpsc_sac_cartpole_stab': lambda: train_mpsc_rl('sac', steps // 4, **kw),
        'mpsc_sac_cartpole_track': lambda: train_mpsc_rl('sac', steps // 4, task='track', **kw),
        'mpsc_ppo_quadrotor_2D_stab': lambda: train_mpsc_rl('ppo', steps // 2, **q2, **kw),
        'mpsc_ppo_quadrotor_2D_track': lambda: train_mpsc_rl('ppo', steps // 2, task='track',
                                                             **q2, **kw),
        'mpsc_sac_quadrotor_2D_stab': lambda: train_mpsc_rl('sac', steps // 4, **q2, **kw),
        'mpsc_sac_quadrotor_2D_track': lambda: train_mpsc_rl('sac', steps // 4, task='track',
                                                             **q2, **kw),
        # CBF.
        'cbf_nn': lambda: learn_cbf_nn(**kw),
    }


def main(argv=None):
    """Run the jobs of ``argv`` (default ``sys.argv[1:]``); returns the written
    paths by job."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=45000)
    parser.add_argument('--tpu_scale', action='store_true')
    parser.add_argument('--only', nargs='*', default=None, help='subset of job names to run')
    parser.add_argument('--out_dir', default=DEFAULT_OUT_DIR)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    out_dir = os.path.abspath(args.out_dir)
    if os.path.commonpath([out_dir, EXAMPLES_DIR]) == EXAMPLES_DIR:
        raise ValueError(f'--out_dir {out_dir} lies in examples/, whose models are the '
                         'committed ones')
    table = jobs(args.steps, out_dir, args.device)
    return {name: table[name]() for name in (args.only if args.only else list(table))}


if __name__ == '__main__':
    main()
