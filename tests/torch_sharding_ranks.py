"""The rank side of the port's distributed tests: cases each rank runs under
``parallel/launch.spawn_local``, and the one-process runs they are held to.

This module imports the port and never JAX, so that the spawned ranks start
quickly; ``tests/test_torch_sharding.py`` and
``tests/test_torch_sharded_training.py`` hold its results against the
one-process port and the JAX package. Every case returns numpy.
"""

import contextlib
import os
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from safe_control_gym_tpu_torch.math.optim import tree_leaves
from safe_control_gym_tpu_torch.parallel import sharding
from safe_control_gym_tpu_torch.parallel.launch import free_port
from safe_control_gym_tpu_torch.utils.registration import get_config, make

# tests/test_multichip_training.py's env and learners, cut to few steps.
CFG = dict(cost='rl_reward', normalized_rl_action_space=True, episode_len_sec=3, ctrl_freq=15,
           pyb_freq=750, randomized_init=True)
ADV_CFG = dict(CFG, adversary_disturbance='dynamics', adversary_disturbance_scale=1.0)
QUIET = dict(log_interval=0, save_interval=0, eval_interval=0)
# Every second iteration's evaluation runs on every rank.
PPO_CFG = dict(rollout_batch_size=16, rollout_steps=32, opt_epochs=2, mini_batch_size=128,
               fused_iterations=2, max_env_steps=16 * 32 * 4, actor_lr=3e-4, critic_lr=1e-3,
               **dict(QUIET, eval_interval=16 * 32 * 2), eval_batch_size=4)
RARL_CFG = dict(rollout_batch_size=16, rollout_steps=32, agent_iterations=1,
                adversary_iterations=1, opt_epochs=2, mini_batch_size=128, fused_iterations=1,
                max_env_steps=16 * 32 * 2 * 2, log_interval=0)
# tests/test_multichip_training.py:212-215: SAC at its equivalence horizon.
SAC_CFG = dict(rollout_batch_size=8, train_interval=32, train_batch_size=64, warm_up_steps=256,
               max_buffer_size=4000, fused_iterations=1, max_env_steps=512, **QUIET)
# dp x tp's horizon: 64 updates past the warm-up. At 512 steps the
# one-process run is on a float32 knife edge (tests/test_torch_sharded_training.py).
SAC_TP_STEPS = 320
# tests/test_sharded_solvers.py's constrained cartpole, problems and solvers.
CONSTRAINED_CARTPOLE = dict(
    seed=42, cost='quadratic', ctrl_freq=15, pyb_freq=750, episode_len_sec=6,
    randomized_init=False, init_state={'init_theta': 0.1},
    task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.005},
    constraints=[{'constraint_form': 'default_constraint', 'constrained_variable': 'state',
                  'upper_bounds': [1.5, 2, 0.3, 2], 'lower_bounds': [-1.5, -2, -0.3, -2]},
                 {'constraint_form': 'default_constraint', 'constrained_variable': 'input',
                  'upper_bounds': [5], 'lower_bounds': [-5]}])
MPSC_CFG = dict(horizon=10, q_lin=[1], r_lin=[1], integration_algo='rk4', n_samples=4,
                tau=0.95, seed=0, use_terminal_set=False)
NMPC_CFG = dict(q_mpc=[1], r_mpc=[0.1], horizon=10, sqp_iters=3, seed=0)
# tests/test_torch_safety_filters.py's CBF cartpole and rows.
CBF_ENV = dict(seed=42, randomized_init=False, constraints=CONSTRAINED_CARTPOLE['constraints'])
CBF_STATES = np.array([[0, 0, 0, 0], [0, 0, 0.28, 1.0], [0, 0, -0.2, -0.5],
                       [0.1, -0.2, 0.15, 0.4]], np.float32)
CBF_ACTIONS = np.array([[0.1], [3.0], [-3.0], [1.5]], np.float32)
CERT_STATES = np.random.default_rng(3).normal(0, 0.08, (8, 4)).astype(np.float32)
CERT_ACTIONS = np.random.default_rng(3).uniform(-1, 1, (8, 1)).astype(np.float32)
NMPC_X0 = np.random.default_rng(5).uniform(-0.3, 0.3, (16, 4)).astype(np.float32)
# tests/test_fused_eval.py:136's eval of tests/test_torch_fused_eval.py's
# fixed start, on the committed cartpole model.
EVAL_TASK = dict(randomized_init=False, init_state={'init_x': 0.1, 'init_theta': 0.05})
EVAL_KW = dict(batch=32, n_steps=150, seed=4, return_per_env=True, n_reps=0)
POP_CFG = dict(rollout_batch_size=4, rollout_steps=8, iterations=2, opt_epochs=2,
               mini_batch_size=16, hidden_dim=16, n_eval=2, use_gae=True)
# Lanes 0 and 2 repeat lanes 1 and 3's seed and hyperparameters: identical
# lanes on different ranks.
POP_SEEDS = [7, 9, 7, 9]
POP_HP = {'actor_lr': np.array([3e-3, 1e-3, 3e-3, 1e-3], np.float32)}


@contextlib.contextmanager
def one_rank():
    """A gloo process group of this process alone, for the length of the
    block."""
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{free_port()}', rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def k1_rows():
    """The row count of each call of K1's plain version (K1 on the CPU)
    inside the block, as a list."""
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    plain, rows = pk.cartpole_advance_plain, []

    def counting(states, *args, **kwargs):
        rows.append(int(states.shape[0]))
        return plain(states, *args, **kwargs)

    pk.cartpole_advance_plain = counting
    try:
        yield rows
    finally:
        pk.cartpole_advance_plain = plain


def _np(leaves):
    return [t.detach().cpu().numpy() for t in leaves]


def _opt(state):
    return [state['count'].cpu().numpy()] + _np(state['mu']) + _np(state['nu'])


# -- the helpers -------------------------------------------------------------

def helpers(mesh):
    """``make_sharded_env_step``, ``shard_env_batch``, ``replicate`` and
    ``make_dp_train_step`` on 8 cartpoles: this rank's obs after a reset and
    two auto-reset steps of random actions (drawn whole), a replicated
    tensor, and a data-parallel step's result."""
    func = make('cartpole', device='cpu', seed=5, **CFG).func
    reset_fn, step_fn = sharding.make_sharded_env_step(mesh, func)
    gen = torch.Generator().manual_seed(0)
    est, obs = reset_fn(gen, 8)
    out = {'reset_obs': obs.numpy()}
    acts = torch.rand((2, 8, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1
    for t in range(2):
        est, step, obs = step_fn(est, sharding.shard_env_batch(mesh, acts[t]), gen)
        out[f'obs{t}'] = obs.numpy()
        out[f'done{t}'] = step.done.numpy()
    rank = torch.full((3,), float(mesh.rank))
    out['replicated'] = sharding.replicate(mesh, {'w': rank})['w'].numpy()
    run = sharding.make_dp_train_step(mesh, lambda p, b: (p['w'] * b['x'].sum(), b['x']))
    lo, hi = mesh.rows(8, 'env')
    value, batch = run({'w': torch.full((2,), float(mesh.rank + 1))},
                       {'x': torch.arange(8.0)[lo:hi]})
    out['dp_step'], out['dp_batch'] = value.numpy(), batch.numpy()
    return out


def helpers_one_process():
    """``helpers``'s reset and steps on one process, all 8 envs."""
    func = make('cartpole', device='cpu', seed=5, **CFG).func
    gen = torch.Generator().manual_seed(0)
    est, obs = func.reset_batch(gen, 8)
    out = {'reset_obs': obs.numpy()}
    acts = torch.rand((2, 8, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1
    for t in range(2):
        est, step, obs = func.step_autoreset(est, acts[t], gen)
        out[f'obs{t}'] = obs.numpy()
        out[f'done{t}'] = step.done.numpy()
    return out


# -- learners ----------------------------------------------------------------

def ppo(out, mesh=None, model_axis=None):
    """tests/test_multichip_training.py's PPO at 4 iterations: the whole
    parameters, this rank's shards, both Adam states (this rank's), the last
    results, K1's count of plain calls, and the final checkpoint's path where
    this rank wrote it."""
    ctrl = make('ppo', partial(make, 'cartpole', device='cpu', seed=5, **CFG), training=True,
                seed=2, output_dir=out, **{**get_config('ppo'), **PPO_CFG})
    ctrl.reset()
    if mesh is not None:
        ctrl.shard_over(mesh, model_axis=model_axis)
    with k1_rows() as calls:
        ctrl.learn()
    ag = ctrl.agent
    return dict(params=_np(tree_leaves(ag.full_params())), shards=_np(tree_leaves(ag.params)),
                actor_opt=_opt(ag.actor_opt_state), critic_opt=_opt(ag.critic_opt_state),
                results=ctrl.last_results, obs_rows=ctrl._obs.shape[0], k1_calls=calls,
                checkpoint=ctrl.checkpoint_path if os.path.exists(ctrl.checkpoint_path) else None)


def rarl(out, algo, mesh=None):
    """tests/test_multichip_training.py's RARL or RAP for two cycles: every
    agent's parameters and the last results."""
    ctrl = make(algo, partial(make, 'cartpole', device='cpu', seed=5, **ADV_CFG),
                training=True, seed=2, output_dir=out, **{**get_config(algo), **RARL_CFG})
    ctrl.reset()
    if mesh is not None:
        ctrl.shard_over(mesh)
    ctrl.learn()
    return dict(params=[_np(tree_leaves(a.params)) for a in ctrl._all_agents()],
                opt=[_opt(a.actor_opt_state) for a in ctrl._all_agents()],
                results=ctrl.last_results)


def sac(out, mesh=None, model_axis=None, steps=SAC_CFG['max_env_steps']):
    """tests/test_multichip_training.py's SAC to ``steps`` env steps: the
    whole parameters, this rank's shards and train state, the last
    results."""
    ctrl = make('sac', partial(make, 'cartpole', device='cpu', seed=5, **CFG), training=True,
                seed=2, output_dir=out,
                **{**get_config('sac'), **SAC_CFG, 'max_env_steps': steps})
    ctrl.reset()
    if mesh is not None:
        ctrl.shard_over(mesh, model_axis=model_axis)
    ctrl.learn()
    ag = ctrl.agent
    return dict(params=_np(tree_leaves(ag.full_params())), shards=_np(tree_leaves(ag.params)),
                train_state=_np(tree_leaves(ag.train_state())), results=ctrl.last_results,
                buffer_rows=int(ctrl.buffer.count))


def ppo_update(mesh, state, batch, perms):
    """One PPO update of the agent ``state`` (``PPOAgent.state_dict``'s
    layout) on ``batch`` (M rows, this rank's rows of it) on JAX's
    permutations: the parameters and the accepted actor steps."""
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import PPOAgent
    from safe_control_gym_tpu_torch.envs.spaces import Box
    box = lambda n: Box(-np.ones(n, np.float32), np.ones(n, np.float32))
    agent = PPOAgent(box(4), box(2),
                     hidden_dim=16, opt_epochs=2, mini_batch_size=16, seed=3, target_kl=0.004,
                     actor_lr=3e-3, critic_lr=3e-3, device='cpu')
    agent.load_state_dict(state)
    m = batch['obs'].shape[0]
    rows = None
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    if mesh is not None:
        agent.shard(mesh)
        shards = sharding.EnvShards(mesh, 'env', m, 'cpu')
        rows = shards.batch_rows(1)[0]
        tb = shards.take(tb)
    losses = agent.update_tensors(tb, perms=perms, rows=rows)
    return dict(params=_np(tree_leaves(agent.params)), losses=losses.numpy(),
                accepted=int(agent.actor_opt_state['count']))


# -- solvers, eval, population -----------------------------------------------

def certify(mesh, p_path):
    """The linear MPSC certification batch of tests/test_sharded_solvers.py
    (the committed P) and the refusal of a batch that does not divide over
    the mesh."""
    env_func = partial(make, 'cartpole', device='cpu', **CONSTRAINED_CARTPOLE)
    sf = make('linear_mpsc', env_func, **MPSC_CFG)
    sf.load(p_path)
    if mesh is not None:
        sf.shard_over(mesh)
    u, ok = sf.certify_action_batch(CERT_STATES, CERT_ACTIONS)
    out = dict(u=u, ok=ok, local_rows=sf.batch_plans[0].shape[0])
    if mesh is not None and mesh.shape['data'] > 1:
        try:
            sf.certify_action_batch(CERT_STATES[:7], CERT_ACTIONS[:7])
        except ValueError as exc:
            out['indivisible'] = str(exc)
    return out


def nmpc(mesh):
    """tests/test_sharded_solvers.py's NMPC sweep of 16 problems."""
    ctrl = make('mpc', partial(make, 'cartpole', device='cpu', **CONSTRAINED_CARTPOLE),
                **NMPC_CFG)
    ctrl.reset()
    if mesh is not None:
        ctrl.shard_over(mesh)
    u, feas = ctrl.select_action_batch(NMPC_X0)
    return dict(u=u, feas=feas, local_rows=ctrl.batch_horizons[0].shape[0])


def cbf_nn(mesh, model_path):
    """The committed CBF-NN's certification of four rows (CBF_NN inherits
    CBF's batch split)."""
    sf = make('cbf_nn', partial(make, 'cartpole', device='cpu', **CBF_ENV), seed=0)
    sf.load(model_path)
    if mesh is not None:
        sf.shard_over(mesh)
    u, ok = sf.certify_action_batch(CBF_STATES, CBF_ACTIONS)
    return dict(u=u, ok=ok)


def mpc_indivisible(out):
    """``MPC.shard_over`` and GP-MPC's (inherited) on two ranks: a batch of 3
    raises ValueError before any solve (GP-MPC untrained: its own batch
    would raise RuntimeError). The messages, MPC's then GP-MPC's."""
    env_func = partial(make, 'cartpole', device='cpu')
    mesh = sharding.make_env_mesh(axis_name='data')
    messages = []
    for algo, kw in (('mpc', dict(horizon=3)), ('gp_mpc', dict(horizon=3))):
        ctrl = make(algo, env_func, output_dir=out, **kw)
        ctrl.shard_over(mesh)
        try:
            ctrl.select_action_batch(np.zeros((3, 4), np.float32))
        except ValueError as exc:
            messages.append(str(exc))
    return messages


def eval_task():
    """The committed cartpole PPO's env id, task (from a fixed start) and
    algorithm config."""
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    env_id, task, algo_cfg = eval_config('ppo', 'cartpole')
    return env_id, {**task, **EVAL_TASK}, algo_cfg


def evaluate(mesh, model_path):
    """``evaluate_fused`` of the committed cartpole PPO over 32 envs, and the
    refusal of ``use_kernel=True`` with a mesh."""
    env_id, task, algo_cfg = eval_task()
    ctrl = make('ppo', partial(make, env_id, device='cpu', **task), **algo_cfg)
    ctrl.load(model_path)
    with k1_rows() as calls:
        res = ctrl.evaluate_fused(mesh=mesh, **EVAL_KW)
    res['k1_calls'] = calls
    if mesh is not None:
        try:
            ctrl.evaluate_fused(mesh=mesh, use_kernel=True, **EVAL_KW)
        except ValueError as exc:
            res['kernel_refusal'] = str(exc)
    return res


def population(mesh):
    """A population of four lanes, two pairs of identical lanes."""
    from safe_control_gym_tpu_torch.hyperparameters.population import \
        make_population_ppo_evaluator
    ev = make_population_ppo_evaluator(
        partial(make, 'cartpole', normalized_rl_action_space=True, episode_len_sec=1),
        device='cpu', mesh=mesh, **POP_CFG)
    return dict(returns=ev(POP_HP, POP_SEEDS))


def fail_on_rank(bad):
    """Rank ``bad`` raises; every other rank waits in a collective that
    can never complete."""
    if dist.get_rank() == bad:
        raise ValueError(f'rank {bad} fails on purpose')
    dist.all_reduce(torch.zeros(1))


# -- the spawned runs ----------------------------------------------------------

def two_ranks(out, ppo_state, ppo_batch, ppo_perms, p_path, model_path, cbf_path):
    """Every case on a W=2 'env' mesh (and a W=2 'data' or 'pop' mesh);
    each rank writes under ``out``/rank<r>."""
    env = sharding.make_env_mesh()
    data = sharding.make_env_mesh(axis_name='data')
    pop = sharding.make_env_mesh(axis_name='pop')
    out = f'{out}/rank{dist.get_rank()}'
    return dict(helpers=helpers(env), ppo=ppo(f'{out}/ppo', env),
                rarl=rarl(f'{out}/rarl', 'rarl', env),
                rap=rarl(f'{out}/rap', 'rap', env), sac=sac(f'{out}/sac', env),
                ppo_update=ppo_update(env, ppo_state, ppo_batch, ppo_perms),
                certify=certify(data, p_path), nmpc=nmpc(data),
                cbf_nn=cbf_nn(data, cbf_path),
                eval=evaluate(env, model_path), population=population(pop),
                rank=dist.get_rank())


def one_process(out, ppo_state, ppo_batch, ppo_perms, p_path, model_path, cbf_path):
    """``two_ranks``'s cases unsharded: the one-process runs they are held
    to (run in a process of their own, beside the ranks)."""
    return dict(helpers=helpers_one_process(),
                certify=certify(None, p_path), nmpc=nmpc(None),
                cbf_nn=cbf_nn(None, cbf_path), eval=evaluate(None, model_path),
                ppo_update=ppo_update(None, ppo_state, ppo_batch, ppo_perms),
                ppo=ppo(f'{out}/ppo'), rarl=rarl(f'{out}/rarl', 'rarl'),
                rap=rarl(f'{out}/rap', 'rap'), sac=sac(f'{out}/sac'))


def dp_tp(out):
    """PPO and SAC on a (2, 2) dp x tp mesh, and the Megatron shardings of
    PPO's and SAC's parameters there."""
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import init_actor_critic
    from safe_control_gym_tpu_torch.controllers.sac.sac_utils import init_sac_params
    mesh = sharding.make_dp_tp_mesh(n_model=2)
    gen = torch.Generator().manual_seed(0)
    specs = {'ppo': sharding.actor_critic_tp_shardings(
                 mesh, init_actor_critic(gen, 4, 1, [64, 64]), 'model'),
             'sac': sharding.actor_critic_tp_shardings(
                 mesh, init_sac_params(gen, 4, 1, [256, 256])[0], 'model')}
    out = f'{out}/rank{dist.get_rank()}'
    return dict(ppo=ppo(f'{out}/ppo', mesh, 'model'),
                sac=sac(f'{out}/sac', mesh, 'model', steps=SAC_TP_STEPS),
                coords=dict(mesh.coords), specs=specs)
