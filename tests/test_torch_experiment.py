"""The port's experiment harness (``experiments/base_experiment.py``) against
the JAX package's on the CPU: ``BaseExperiment.run_evaluation`` with LQR on
tests/test_safety_filters.py's constrained cartpole, uncertified and
certified by linear MPSC loaded from the committed ``.pkl`` (the filter
pair of tests/test_torch_safety_filters.py, whose port filter takes JAX's
LQR gain); the ``RecordDataWrapper`` and ``MetricExtractor``; the step
budget and seeds.

Tolerances, and why:
* Uncertified: episode lengths and constraint-violation counts exactly,
  returns and RMSE to 1e-4 (relative; the same float32 physics step by
  step, sums in another order).
* Certified (2 s episodes, 30 steps): the JAX run is recorded, and the
  port's filter, given JAX's observation and warm state before each step,
  gives JAX's action within 1e-4, or, where JAX's own action moves by more
  under 1e-7 relative changes of its observation (the polish picks its
  candidate by rounding), one of JAX's answers to those changes within
  1e-4. A free-running comparison would add each step's rounding to the
  next step's state. The port's own certified run has JAX's
  ``safety_filter_data`` keys, and a length each per episode.
"""

import functools

import numpy as np
import pytest
import torch

from safe_control_gym_tpu.experiments.base_experiment import BaseExperiment as JExperiment
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments.base_experiment import (BaseExperiment,
                                                                    MetricExtractor,
                                                                    RecordDataWrapper)
from safe_control_gym_tpu_torch.utils.registration import make as tmake

from tests.test_torch_safety_filters import (CONSTRAINED_CARTPOLE, MODELS, MPSC_CFG, _agree,
                                             _mpsc, _set_warm, _warm_of)

LQR = dict(q_lqr=[1], r_lqr=[0.1])
METRICS_EXACT = ('average_length', 'length', 'average_constraint_violation',
                 'constraint_violation', 'failure_rate', 'constraint_violation_std')
METRICS_CLOSE = ('average_return', 'average_rmse', 'rmse', 'rmse_std', 'worst_case_rmse_at_0.5')


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    # The port's small CPU solves run on one thread: torch's pool contends
    # with JAX's and with the other test workers (under pytest-xdist beside
    # five other workers, torch's default pool made tests/test_torch_gp_mpc.py
    # take 778 s against about 60 s alone). The prior count comes back at the
    # end of the module, so that the files a worker runs next keep theirs.
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def _env_funcs(**task):
    task = dict(CONSTRAINED_CARTPOLE, **task)
    return (functools.partial(jmake, 'cartpole', **task),
            functools.partial(tmake, 'cartpole', device='cpu', **task))


def test_uncertified_run_matches_jax():
    j_env, t_env = _env_funcs()
    runs = []
    for make, env_func in ((jmake, j_env), (tmake, t_env)):
        exp = (JExperiment if make is jmake else BaseExperiment)(
            env_func(), make('lqr', env_func, **LQR))
        runs.append(exp.run_evaluation(n_episodes=2, verbose=False))
        exp.close()
    (d_j, m_j), (d_t, m_t) = runs
    assert set(m_t) == set(m_j)
    for k in METRICS_EXACT:
        np.testing.assert_array_equal(m_t[k], m_j[k], err_msg=k)
    for k in METRICS_CLOSE:
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-4, err_msg=k)
    assert m_t['average_length'] == 80 and m_t['average_constraint_violation'] == 0
    for key in ('obs', 'state', 'action', 'reward', 'length'):
        assert [len(e) for e in d_t[key]] == [len(e) for e in d_j[key]], key
        np.testing.assert_allclose(np.concatenate(d_t[key]).astype(float),
                                   np.concatenate(d_j[key]).astype(float), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    assert set(d_t) == set(d_j)
    assert list(d_t['controller_data']) == list(d_j['controller_data'])
    # The port's extractor on JAX's recorded data gives JAX's metrics.
    m_x = MetricExtractor().compute_metrics(d_j)
    for k in m_j:
        np.testing.assert_array_equal(m_x[k], m_j[k], err_msg=k)


def test_certified_run_matches_jax():
    j_sf, t_sf = _mpsc('cartpole')
    j_env, t_env = _env_funcs(episode_len_sec=2)
    steps = []
    certify = j_sf.certify_action

    def recording(state, action, info=None):
        warm = _warm_of(j_sf)
        out = certify(state, action, info)
        steps.append((np.array(state), np.array(action), info, warm, out))
        return out
    j_sf.certify_action = recording
    exp = JExperiment(j_env(), jmake('lqr', j_env, **LQR), safety_filter=j_sf)
    d_j, m_j = exp.run_evaluation(n_episodes=1, verbose=False)
    del j_sf.certify_action
    assert m_j['average_constraint_violation'] == 0 and len(steps) == m_j['average_length']
    t_sf.reset_before_run()
    for k, (state, action, info, warm, (u_j, ok_j)) in enumerate(steps):
        def jax_certify(s):
            _set_warm(j_sf, warm)
            return j_sf.certify_action(s, action, info)[0]
        _set_warm(t_sf, warm)
        u_t, ok_t = t_sf.certify_action(state, action, info)
        assert ok_t == ok_j, k
        assert _agree(u_t, u_j, jax_certify, state), (k, u_t, u_j)
    exp = BaseExperiment(t_env(), tmake('lqr', t_env, **LQR), safety_filter=t_sf)
    d_t, m_t = exp.run_evaluation(n_episodes=1, verbose=False)
    exp.close()
    assert m_t['average_constraint_violation'] == 0
    assert m_t['average_length'] == m_j['average_length'] == 30
    sfd_t, sfd_j = d_t['safety_filter_data'], d_j['safety_filter_data']
    assert set(sfd_t) == set(sfd_j) == {'feasible', 'kinf', 'uncertified_action',
                                        'certified_action', 'correction'}
    for key in sfd_t:
        assert len(sfd_t[key]) == len(sfd_j[key]) == 1
        assert len(sfd_t[key][0]) == m_t['average_length'], key
    assert np.asarray(sfd_t['feasible'][0]).all()
    assert sfd_t.correction is sfd_t['correction']


def test_step_budget_seeds_and_wrapper():
    # The cbf example's cartpole (randomized init), LQR.
    task = dict(CONSTRAINED_CARTPOLE, randomized_init=True, ctrl_freq=50, pyb_freq=50)
    env_func = functools.partial(tmake, 'cartpole', device='cpu', **task)
    exp = BaseExperiment(env_func(), tmake('lqr', env_func, **LQR))
    assert isinstance(exp.env, RecordDataWrapper)
    assert exp.env.CTRL_FREQ == 50 and exp.env.symbolic.nx == 4
    assert RecordDataWrapper(exp.env) is not exp.env
    data, metrics = exp.run_evaluation(n_steps=7, verbose=False)
    assert [len(a) for a in data['action']] == [7] and metrics['length'] == 7
    assert [len(o) for o in data['obs']] == [8]
    first = []
    for _ in range(2):
        data, _ = exp.run_evaluation(n_episodes=2, seeds=[3, 4], verbose=False)
        first.append(np.stack([o[0] for o in data['obs']]))
    np.testing.assert_array_equal(first[0], first[1])
    assert not np.array_equal(first[0][0], first[0][1])
    with pytest.raises(ValueError, match='Exactly one'):
        exp.run_evaluation(n_episodes=1, n_steps=3, verbose=False)
    calls = []

    class Learner:
        results_dict = {}

        def reset(self):
            pass

        def learn(self, env=None, **kwargs):
            calls.append(env)
    exp = BaseExperiment(env_func(), Learner(), train_env=env_func())
    assert exp.launch_training() == {}
    assert calls == [exp.train_env]


def cpu_reference():
    """BASELINE.json's fifth config (SAC + linear MPSC on the 2D quad, the
    committed model and P, examples/mpsc/mpsc_experiment.py's shaping) on
    the CPU through both packages, and the RPI set's log det of both on the
    cartpole residuals of the port's learn() under two 1e-7 relative changes
    (numpy seed 1). Prints one JSON line each; run it with
    ``JAX_PLATFORMS=cpu python -m tests.test_torch_experiment``."""
    import json

    from safe_control_gym_tpu.safety_filters.mpsc.mpsc_utils import \
        compute_RPI_set as jrpi
    from safe_control_gym_tpu.utils.registration import get_config as jget
    from safe_control_gym_tpu_torch.experiments.control_configs import safety_config
    from safe_control_gym_tpu_torch.safety_filters.mpsc.mpsc_utils import \
        compute_RPI_set as trpi
    torch.set_num_threads(1)
    env_id, task, algo, sfs = safety_config('mpsc', 'quadrotor_2D', 'stab', 'sac')
    task = dict(task, randomized_init=False)
    sf_task = dict(task, cost='quadratic', normalized_rl_action_space=False)
    for name, make, exp_cls, kw in (('jax', jmake, JExperiment, {}),
                                    ('port', tmake, BaseExperiment, {'device': 'cpu'})):
        env_func = functools.partial(make, env_id, **kw, **task)
        cfg = dict(jget('sac'), **algo) if make is jmake else algo
        ctrl = make('sac', env_func, **dict(cfg, training=False))
        ctrl.load(f'{MODELS}/sac_model_quadrotor_2D_stab.pt')
        sf = make('linear_mpsc', functools.partial(make, env_id, **kw, **sf_task),
                  **sfs['linear_mpsc'])
        sf.load(f'{MODELS}/linear_mpsc_quadrotor_2D.pkl')
        out = {}
        for run, filt in (('uncertified', None), ('certified', sf)):
            exp = exp_cls(env_func(), ctrl, safety_filter=filt)
            data, m = exp.run_evaluation(n_episodes=1, verbose=False)
            exp.close()
            ctrl.reset()
            out[run] = {k: float(m[k]) for k in ('average_length', 'average_return',
                                                 'average_constraint_violation')}
            if filt is not None:
                sfd = data['safety_filter_data']
                out[run].update(feasible_share=float(np.mean(sfd['feasible'][0])),
                                mean_correction=float(np.mean(sfd['correction'][0])))
        print(json.dumps({'config 5 on the CPU': name, **out}))
    t = tmake('linear_mpsc', functools.partial(tmake, 'cartpole', device='cpu',
                                               **CONSTRAINED_CARTPOLE), **MPSC_CFG)
    t.learn()
    A = t.discrete_dfdx + t.discrete_dfdu @ t.lqr_gain
    rng = np.random.default_rng(1)
    ws = [t.residuals if k == 0 else t.residuals * (1 + 1e-7 * rng.standard_normal(
        t.residuals.shape)) for k in range(3)]
    print(json.dumps({'RPI log det, cartpole residuals (120)': {
        'jax': [float(np.linalg.slogdet(jrpi(A, w, 0.95))[1]) for w in ws],
        'port': [float(np.linalg.slogdet(trpi(A, w, 0.95, device='cpu'))[1]) for w in ws]}}))


if __name__ == '__main__':
    cpu_reference()
