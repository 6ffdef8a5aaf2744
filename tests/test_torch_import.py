"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import functools
import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'safe_control_gym_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'chex', 'safe_control_gym_tpu', 'gymnasium')


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_import_leaves_jax_out_of_sys_modules(tmp_path):
    code = ('import sys, safe_control_gym_tpu_torch\n'
            'import safe_control_gym_tpu_torch.envs.cartpole\n'
            'import safe_control_gym_tpu_torch.envs.quadrotor\n'
            'import safe_control_gym_tpu_torch.ops.rollout_kernels\n'
            'import safe_control_gym_tpu_torch.experiments.benchmark_suite\n'
            'import safe_control_gym_tpu_torch.utils.convert\n'
            'import safe_control_gym_tpu_torch.experiments.fused_eval\n'
            'import safe_control_gym_tpu_torch.controllers.ppo.ppo\n'
            'import safe_control_gym_tpu_torch.controllers.sac.sac\n'
            'import safe_control_gym_tpu_torch.controllers.ddpg.ddpg\n'
            'import safe_control_gym_tpu_torch.envs.symbolic\n'
            'import safe_control_gym_tpu_torch.math.linalg\n'
            'import safe_control_gym_tpu_torch.controllers.lqr.ilqr\n'
            'import safe_control_gym_tpu_torch.controllers.pid.pid\n'
            'import safe_control_gym_tpu_torch.experiments.control_configs\n'
            'import safe_control_gym_tpu_torch.ops.qp\n'
            'import safe_control_gym_tpu_torch.controllers.mpc.mpc\n'
            'import safe_control_gym_tpu_torch.controllers.mpc.linear_mpc\n'
            'import safe_control_gym_tpu_torch.controllers.mpc.mpc_acados\n'
            'import safe_control_gym_tpu_torch.controllers.mpc.gp_utils\n'
            'import safe_control_gym_tpu_torch.controllers.mpc.gp_mpc\n'
            'import safe_control_gym_tpu_torch.math.schedules\n'
            'import safe_control_gym_tpu_torch.math.random_processes\n'
            'import safe_control_gym_tpu_torch.controllers.safe_explorer.safe_ppo\n'
            'import safe_control_gym_tpu_torch.controllers.rarl.rap\n'
            'from functools import partial\n'
            'from safe_control_gym_tpu_torch.utils.registration import make\n'
            'from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint\n'
            'for m in ("ppo/ppo_model_quadrotor_3D_stab.pt", "sac/sac_model_cartpole_stab.pt"):\n'
            '    load_checkpoint("examples/rl/models/" + m)\n'
            'ctrl = make("ppo", partial(make, "cartpole", device="cpu"))\n'
            'ctrl.load("examples/rl/models/ppo/ppo_model_cartpole_stab.pt")\n'
            'ilqr = make("ilqr", partial(make, "cartpole", device="cpu", cost="quadratic"),'
            ' max_iterations=1)\n'
            'ilqr.solve_batch(ilqr.env._nominal_init_state()[None])\n'
            'make("pid", partial(make, "quadrotor", device="cpu"))\n'
            'mpc = make("linear_mpc", partial(make, "cartpole", device="cpu"), horizon=3)\n'
            'mpc.reset(); mpc.select_action_batch(mpc.env._nominal_init_state()[None])\n'
            'gp = make("gp_mpc", partial(make, "cartpole", device="cpu"), horizon=3,'
            ' num_samples=4, optimization_iterations=2)\n'
            'gp.reset(); gp.learn(); gp.select_action(gp.env._nominal_init_state())\n'
            'import safe_control_gym_tpu_torch.experiments.base_experiment\n'
            'import safe_control_gym_tpu_torch.safety_filters.cbf.cbf_nn\n'
            'box = [{"constraint_form": "default_constraint", "constrained_variable": v}'
            ' for v in ("state", "input")]\n'
            'sf = make("linear_mpsc", partial(make, "cartpole", device="cpu", constraints=box),'
            ' horizon=3, n_samples=4)\n'
            'sf.load("examples/mpsc/models/linear_mpsc_cartpole.pkl")\n'
            'sf.certify_action_batch(sf.env._nominal_init_state()[None], [[0.0]])\n'
            'make("cbf_nn", partial(make, "cartpole", device="cpu", constraints=box)).load('
            '"examples/cbf/models/cbf_nn_cartpole.pt")\n'
            'sac = make("sac", partial(make, "cartpole", device="cpu"), hidden_dim=8,'
            ' max_env_steps=8, warm_up_steps=4, train_interval=4, train_batch_size=4,'
            ' max_buffer_size=16, output_dir=%r, checkpoint_path="")\n'
            'sac.reset(); sac.learn()\n'
            'se = make("safe_explorer_ppo", partial(make, "cartpole", device="cpu",'
            ' constraints=[{"constraint_form": "abs_bound", "constrained_variable": "state",'
            ' "bound": [1.5, 2.0, 0.3, 2.0]}]))\n'
            'se.load("examples/rl/models/safe_explorer_ppo/safe_explorer_ppo_model_cartpole_stab.pt")\n'
            'rap = make("rap", partial(make, "cartpole", device="cpu",'
            ' adversary_disturbance="dynamics"), rollout_steps=2, max_env_steps=8,'
            ' agent_iterations=1, adversary_iterations=1, output_dir=%r,'
            ' checkpoint_path="")\n'
            'rap.reset(); rap.learn()\n'
            'import safe_control_gym_tpu_torch.utils.profiling\n'
            'import safe_control_gym_tpu_torch.utils.plotting\n'
            'import safe_control_gym_tpu_torch.version\n'
            'from safe_control_gym_tpu_torch.utils import yaml_io\n'
            'yaml_io.load_file("examples/hpo/config_overrides/ppo_cartpole_hpo.yaml")\n'
            'from safe_control_gym_tpu_torch.experiments.train_rl_controller import train\n'
            'from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env import'
            ' make_vec_envs\n'
            'from safe_control_gym_tpu_torch.envs.env_wrappers.record_episode_statistics'
            ' import VecRecordEpisodeStatistics\n'
            'venv = VecRecordEpisodeStatistics(make_vec_envs(partial(make, "cartpole",'
            ' device="cpu"), batch_size=2))\n'
            'venv.reset(); venv.step([[0.0], [0.0]])\n'
            'from safe_control_gym_tpu_torch.hyperparameters.hpo import HPO\n'
            'from safe_control_gym_tpu_torch.hyperparameters.population import'
            ' make_population_ppo_evaluator\n'
            'make_population_ppo_evaluator(partial(make, "cartpole"), rollout_batch_size=2,'
            ' rollout_steps=2, iterations=1, opt_epochs=1, hidden_dim=8, n_eval=1,'
            ' device="cpu")({}, [0])\n'
            'import safe_control_gym_tpu_torch.hyperparameters.database\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)\n'
            'print(bad); sys.exit(1 if bad else 0)'
            % (str(tmp_path / 'sac'), str(tmp_path / 'rap'), FORBIDDEN))
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize('path', sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f'{path} imports {bad}'


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')
    from safe_control_gym_tpu_torch.experiments import benchmark_suite
    from safe_control_gym_tpu_torch.utils.registration import make
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make('cartpole')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make('quadrotor', quad_type=3)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        benchmark_suite.measure_rollout_kernel('cartpole', False, batch=8,
                                               n_steps=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        benchmark_suite.measure_batched('cartpole', False, batch=8, n_steps=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        benchmark_suite.measure_rollout_kernel('quadrotor_3D', True, batch=8,
                                               n_steps=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        benchmark_suite.measure_closed_loop_kernel('cartpole', batch=8, n_steps=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make('sac', functools.partial(make, 'cartpole'))
    for algo in ('ddpg', 'safe_explorer_ppo', 'rarl', 'rap'):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            make(algo, functools.partial(make, 'cartpole', adversary_disturbance='dynamics'))
    for algo in ('lqr', 'ilqr', 'pid', 'mpc', 'linear_mpc', 'mpc_acados', 'gp_mpc',
                 'linear_mpsc', 'cbf', 'cbf_nn'):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            make(algo, functools.partial(make, 'quadrotor' if algo == 'pid' else 'cartpole'))
    ctrl = make('ppo', functools.partial(make, 'cartpole', device='cpu'))
    assert ctrl.device.type == 'cpu' and ctrl.agent.params['logstd'].device.type == 'cpu'
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import PPOAgent
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        PPOAgent(ctrl.env.observation_space, ctrl.env.action_space)
    env = make('cartpole', device='cpu')
    assert env.device.type == 'cpu'
    from safe_control_gym_tpu_torch.controllers.off_policy_utils import replay_init
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        replay_init({'obs': 4}, 8)
    from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env import make_vec_envs
    from safe_control_gym_tpu_torch.experiments.train_rl_controller import train
    from safe_control_gym_tpu_torch.hyperparameters.hpo import HPO
    from safe_control_gym_tpu_torch.hyperparameters.population import \
        make_population_ppo_evaluator
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train(['--algo', 'ppo', '--task', 'cartpole', '--output_dir', 'temp/never'])
    assert not os.path.exists(os.path.join('temp', 'never'))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_vec_envs(functools.partial(make, 'cartpole'), batch_size=2)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        HPO('ppo', 'cartpole', output_dir='temp/never_hpo')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_population_ppo_evaluator(functools.partial(make, 'cartpole', device='cpu'))
    venv = make_vec_envs(functools.partial(make, 'cartpole', device='cpu'), batch_size=2)
    assert venv.device.type == 'cpu'
    pop = make_population_ppo_evaluator(functools.partial(make, 'cartpole'), device='cpu')
    assert pop.device.type == 'cpu' and pop.env.device.type == 'cpu'
