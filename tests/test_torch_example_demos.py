"""The port's batched-solver demos against the JAX package's, on the CPU:
the batched iLQR, MPC, GP-MPC and certification demos, the scenario MPC and
the sharded sweep.

Where both packages compute the same numbers from the same inputs, they are
held within 1e-4: the batched iLQR's costs and MPC's actions, the scenario
candidates and the nominal MPC's cost. Where the numbers come from each
package's own random stream (the RPI descent of a learned filter, the
GP-MPC bootstrap's random actions), the port's figures are held to the JAX
package's own tests' bars. The sharded sweep on two gloo ranks is held to
one process's solve of the same rows (1e-3, phase multigpu's rule).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_examples import load_jax_example


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module, the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def test_batched_ilqr_demo_matches_jax():
    from safe_control_gym_tpu_torch.examples.lqr import batched_ilqr_demo
    want = load_jax_example('lqr/batched_ilqr_demo.py').main(B=4)
    got = batched_ilqr_demo.main(B=4, device='cpu')
    np.testing.assert_allclose(got['cost'], np.asarray(want['cost']), rtol=1e-4)
    np.testing.assert_array_equal(got['converged'], np.asarray(want['converged']))
    np.testing.assert_array_equal(got['iterations'], np.asarray(want['iterations']))


def test_batched_mpc_demo_matches_jax(capsys):
    from safe_control_gym_tpu_torch.examples.mpc import batched_mpc_demo
    _, jax_solve = load_jax_example('mpc/batched_mpc_demo.py').build_batched_solver()
    x0s = np.random.default_rng(0).uniform(-0.3, 0.3, (8, 4)).astype(np.float32)
    want_u, want_res = (np.asarray(a) for a in jax_solve(x0s))
    u0, res = batched_mpc_demo.main(['8', '--device', 'cpu'])
    assert '8/8 converged' in capsys.readouterr().out
    np.testing.assert_allclose(u0, want_u, atol=1e-4)
    assert (res < 1e-2).all() and (want_res < 1e-2).all()


def test_batched_gp_mpc_demo_solves_every_problem(capsys):
    """The JAX test's bar: every problem feasible (the bootstrap's random
    actions are each package's own; tests/test_torch_gp_mpc.py holds the
    batch to JAX's on JAX's data)."""
    from safe_control_gym_tpu_torch.examples.mpc import batched_gp_mpc_demo
    u0, feas, binds = batched_gp_mpc_demo.main(['8', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'GP-MPC solves' in out and '8/8 feasible' in out
    assert feas.all() and np.isfinite(u0).all() and binds.shape == (8,)


def test_scenario_solve_matches_jax_and_the_plain_mpc():
    """The scenario solve of the demo's controller against JAX's (three pole
    lengths) and, with the nominal parameters, against the plain MPC."""
    from functools import partial

    import jax.numpy as jnp

    from safe_control_gym_tpu.envs.dynamics import CartPoleParams as JParams
    from safe_control_gym_tpu.utils.registration import make as jmake
    from safe_control_gym_tpu_torch.examples.mpc import scenario_mpc_demo as demo
    from safe_control_gym_tpu_torch.utils.registration import make
    jdemo = load_jax_example('mpc/scenario_mpc_demo.py')
    kw = dict(q_mpc=[5, 0.1, 5, 0.1], r_mpc=[0.1], horizon=10, warmstart=True, sqp_iters=2)
    prior = {'prior_prop': {'pole_length': demo.NOMINAL_LENGTH}}
    obs = np.array([0.0, 0.0, 0.15, 0.0], np.float32)
    lengths = np.array([demo.NOMINAL_LENGTH, 0.7, 0.9], np.float32)
    full = lambda v: np.full((3,), v, np.float32)
    scen = dict(pole_length=lengths, pole_mass=full(0.1), cart_mass=full(1.0),
                gravity=full(9.8))

    env_func = partial(make, 'cartpole', device='cpu', **demo.TASK)
    plain = make('mpc', env_func, prior_info=prior, **kw)
    plain.reset()
    u_plain = plain.select_action(obs, None)
    ctrl = demo.ScenarioCartpoleMPC(env_func, prior_info=prior, **kw)
    ctrl.reset()
    cands, feas = ctrl.select_action_scenarios(obs, scen)

    jctrl = jdemo.ScenarioCartpoleMPC(partial(jmake, 'cartpole', **jdemo.TASK),
                                      prior_info=prior, **kw)
    jctrl.reset()
    want, want_feas = jctrl.select_action_scenarios(
        obs, JParams(**{k: jnp.asarray(v) for k, v in scen.items()}))
    assert feas.all() and np.array_equal(feas, np.asarray(want_feas))
    np.testing.assert_allclose(cands, np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(cands[0], np.atleast_1d(u_plain), atol=1e-4)
    assert abs(float((cands[2] - cands[0])[0])) > 1e-3


def test_scenario_demo_identifies_the_plant(monkeypatch):
    """``run`` on 1 s episodes (15 steps) against JAX's on the same: the
    nominal MPC's cost within 1e-4, the identified pole length equal, and
    the adaptive controller's cost under the nominal's."""
    from safe_control_gym_tpu_torch.examples.mpc import scenario_mpc_demo as demo
    jdemo = load_jax_example('mpc/scenario_mpc_demo.py')
    monkeypatch.setattr(demo, 'TASK', dict(demo.TASK, episode_len_sec=1))
    monkeypatch.setattr(jdemo, 'TASK', dict(jdemo.TASK, episode_len_sec=1))
    j_nom, j_scen, j_len = jdemo.run(n_scenarios=8, verbose=False)
    nom, scen, length = demo.run(n_scenarios=8, verbose=False, device='cpu')
    np.testing.assert_allclose(nom, j_nom, rtol=1e-4)
    np.testing.assert_allclose(scen, j_scen, rtol=1e-3)
    assert length == pytest.approx(j_len) and abs(length - demo.TRUE_LENGTH) < 0.15
    assert scen < nom


def test_sharded_sweep_on_two_gloo_ranks_matches_one_process(capsys):
    from safe_control_gym_tpu_torch.examples.mpc import sharded_sweep_demo as demo
    res = demo.main(['cpu', '16', '2'])
    out = capsys.readouterr().out
    assert 'NMPC sweep' in out and 'certification sweep' in out and res['world'] == 2
    ctrl, sf = demo.build_solvers('cpu')
    x0s, acts = demo.sweep_inputs(16)
    u, feas = ctrl.select_action_batch(x0s)
    cert, ok = sf.certify_action_batch(x0s, acts)
    assert feas.all() and np.array_equal(res['feasible'], feas)
    np.testing.assert_allclose(res['u'], u, atol=1e-3)
    assert np.array_equal(res['cert_feasible'], ok)
    np.testing.assert_allclose(res['certified'], cert, atol=1e-3)


def test_batched_certification_demo_certifies(capsys):
    """The JAX test's bar (some of the 16 pairs feasible), on the port's own
    learned filter (the RPI descent is chaotic in float32: ROADMAP §3)."""
    from safe_control_gym_tpu_torch.examples.mpsc import batched_certification_demo as demo
    certified, feasible = demo.main(['16', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'certifications' in out
    assert int(out.split('feasible')[0].strip().split()[-1].split('/')[0]) == feasible.sum() > 0
    assert certified.shape == (16, 1) and np.isfinite(certified).all()
