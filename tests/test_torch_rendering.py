"""The port's rendering and viewer against the JAX package's.

* ``render('rgb_array')`` of the cartpole and the 1D, 2D and 3D quads equals
  JAX's frame pixel for pixel from the same state (both draw the state with
  matplotlib under Agg, on the host).
* The cases of the JAX package's tests/test_gui_viewer.py (the viewer
  redraws at every reset and step, ``render('human')`` redraws it, headless
  envs build none), tests/test_rendering.py (frames that change as the
  quad moves, through ``save_video``) and tests/test_env_extras.py:109-131
  (the vec envs' ``get_images`` and tiled ``render``).
* ``BaseExperiment``'s real-time pacing of GUI runs, with ``time.sleep``
  recorded (tests/test_controllers.py:113-125).
* ``MPC.run(render=True)`` collects a frame a step.
"""

import functools
import os
from functools import partial

import numpy as np
import pytest
import torch

from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env import make_env_fn
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.dummy_vec_env import \
    DummyVecEnv
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.subproc_vec_env import \
    SubprocVecEnv
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.torch_vec_env import \
    TorchVecEnv
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.vec_env_utils import \
    tile_images
from safe_control_gym_tpu_torch.experiments import base_experiment
from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
from safe_control_gym_tpu_torch.utils.registration import make as tmake
from safe_control_gym_tpu_torch.utils.utils import save_video


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


CASES = {
    'cartpole': ('cartpole', dict(init_state={'init_theta': 0.2})),
    'cartpole-track': ('cartpole', dict(task='traj_tracking', episode_len_sec=2)),
    'quad1d': ('quadrotor', dict(quad_type=1, init_state={'init_x': 0.8})),
    'quad1d-track': ('quadrotor', dict(quad_type=1, task='traj_tracking', episode_len_sec=2)),
    'quad2d': ('quadrotor', dict(quad_type=2, init_state={'init_z': 1.0},
                                 task_info={'stabilization_goal': [1, 1.5]})),
    'quad2d-track': ('quadrotor', dict(quad_type=2, task='traj_tracking', episode_len_sec=2)),
    'quad3d': ('quadrotor', dict(quad_type=3, init_state={'init_z': 1.0},
                                 task_info={'stabilization_goal': [0, 0, 1]})),
    'quad3d-track': ('quadrotor', dict(
        quad_type=3, task='traj_tracking', episode_len_sec=2,
        task_info={'trajectory_type': 'figure8', 'num_cycles': 1, 'trajectory_plane': 'xz',
                   'trajectory_position_offset': [0, 1], 'trajectory_scale': 1.0})),
}


def _pair(case, **over):
    env_id, kw = CASES[case]
    kw = dict(kw, seed=42, ctrl_freq=50, pyb_freq=500, randomized_init=False, **over)
    return jmake(env_id, **kw), tmake(env_id, device='cpu', **kw)


@pytest.mark.parametrize('case', list(CASES))
def test_frames_equal_jax(case):
    je, te = _pair(case)
    je.reset()
    te.reset()
    if case == 'quad1d':
        # JAX's _draw_state builds the goal marker of every quad type from
        # the goal row and indexes past the 1D quad's two entries
        # (safe_control_gym_tpu/envs/quadrotor.py:801-804): its 1D
        # stabilization frame raises. The port draws it; JAX draws it too
        # once the goal row is padded to the 3D quad's fifth entry, which
        # the 1D marker does not read.
        with pytest.raises(IndexError):
            je.render('rgb_array')
        je.X_GOAL = np.hstack([je.X_GOAL, np.zeros(3)])
    rng = np.random.default_rng(len(case))
    low = te.state_space.low.astype(np.float64)
    high = te.state_space.high.astype(np.float64)
    for i in range(3):
        # A state inside the box (angles within a quarter turn), one copy
        # for both envs.
        state = rng.uniform(np.maximum(low, -1.5), np.minimum(high, 1.5)).astype(np.float32)
        je.state, te.state = state, state.copy()
        je.ctrl_step_counter = te.ctrl_step_counter = 7 * i
        jf, tf = je.render('rgb_array'), te.render('rgb_array')
        assert tf.dtype == np.uint8 and tf.ndim == 3 and tf.shape[2] == 3
        assert float(tf.std()) > 1.0
        np.testing.assert_array_equal(tf, jf)


def test_gui_viewer_redraws_per_step():
    env = tmake('cartpole', device='cpu', gui=True, seed=1, randomized_init=False,
                init_state={'init_theta': 0.1}, ctrl_freq=15, pyb_freq=750, episode_len_sec=1)
    assert env.GUI is True and env._viewer is None  # built at the first reset
    env.reset()
    assert env._viewer is not None and env._viewer.frame_count == 1
    for _ in range(3):
        env.step(np.zeros(1, np.float32))
    assert env._viewer.frame_count == 4
    assert env.render('human') is None
    assert env._viewer.frame_count == 5
    # Headless: the same figure was drawn offscreen.
    env._viewer.fig.canvas.draw()
    frame = np.asarray(env._viewer.fig.canvas.buffer_rgba())
    assert frame.ndim == 3 and float(frame.std()) > 1.0
    env.close()
    assert env._viewer is None


def test_gui_viewer_quadrotor_human_mode():
    env = tmake('quadrotor', device='cpu', quad_type=3, gui=True, seed=3, ctrl_freq=50,
                pyb_freq=1000, episode_len_sec=1, randomized_init=False,
                init_state={'init_z': 1.0},
                task_info={'stabilization_goal': [0, 0, 1], 'stabilization_goal_tolerance': 0.0})
    env.reset()
    env.step(np.asarray(env.U_GOAL, np.float32))
    assert env._viewer.frame_count == 2
    f = env.render('rgb_array')
    assert f.ndim == 3 and f.shape[2] == 3
    env.close()


def test_headless_envs_never_build_a_viewer():
    env = tmake('cartpole', device='cpu', seed=1, ctrl_freq=15, pyb_freq=750, episode_len_sec=1)
    env.reset()
    env.step(np.zeros(1, np.float32))
    assert env._viewer is None
    env.close()


@pytest.mark.parametrize('case', ['quad3d-track', 'cartpole', 'quad1d'])
def test_video_of_frames_that_move(case, tmp_path):
    """tests/test_rendering.py's cases: frames change as the system moves and
    ``save_video`` writes them, as JAX's does."""
    _, env = _pair(case)
    env.reset()
    act = (1.05 * np.asarray(env.U_GOAL, np.float32) if env.NAME == 'quadrotor'
           else np.zeros(1, np.float32))
    frames = []
    for _ in range(4):
        env.step(act)
        frames.append(env.render('rgb_array'))
    assert all(f.dtype == np.uint8 and f.shape == frames[0].shape for f in frames)
    assert float(np.std(frames[0])) > 1.0
    assert not np.array_equal(frames[0], frames[-1])
    path = str(tmp_path / f'{case}.gif')
    save_video(path, frames, fps=10)
    assert os.path.exists(path) and os.path.getsize(path) > 500
    with pytest.raises(AssertionError):
        save_video(str(tmp_path / 'x.avi'), frames)
    env.close()


def test_save_video_without_imageio_writes_pngs(tmp_path, monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name == 'imageio':
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', no_imageio)
    frames = [np.full((8, 8, 3), 40 * i, np.uint8) for i in range(4)]
    save_video(str(tmp_path / 'v.gif'), frames)
    assert sorted(os.listdir(tmp_path)) == [f'v_{i:03d}.png' for i in range(4)]


def test_vec_env_get_images_and_tiled_render():
    """tests/test_env_extras.py's case, on the port's three vec envs; the
    batch's frames are its envs' frames."""
    venv = TorchVecEnv(lambda: tmake('cartpole', device='cpu', seed=0), 4)
    venv.reset()
    imgs = venv.get_images()
    assert len(imgs) == 4 and imgs[0].ndim == 3 and imgs[0].shape[2] == 3
    tiled = venv.render()
    assert tiled.ndim == 3 and tiled.shape[2] == 3
    assert tiled.shape[0] >= imgs[0].shape[0]
    np.testing.assert_array_equal(tiled, tile_images(np.stack(imgs)))
    # Each frame is the template's frame of that env's state.
    template = tmake('cartpole', device='cpu', seed=0)
    template.reset()
    template.state = venv._states.state[2].numpy()
    np.testing.assert_array_equal(imgs[2], template.render())
    assert not np.array_equal(imgs[0], imgs[1])
    venv.close()

    venv = DummyVecEnv([functools.partial(tmake, 'cartpole', device='cpu', seed=i)
                        for i in range(2)])
    venv.reset()
    assert len(venv.get_images()) == 2
    assert venv.render().shape[2] == 3
    venv.close()

    venv = SubprocVecEnv([make_env_fn(partial(tmake, 'quadrotor', quad_type=1), seed=0, rank=i)
                          for i in range(2)], n_workers=1)
    venv.reset()
    imgs = venv.get_images()
    assert len(imgs) == 2 and imgs[0].shape[2] == 3
    venv.close()


def test_visualization_time_multiplier_pacing(monkeypatch):
    """GUI runs are paced to k-by-realtime: with gui=True each control step
    after the first sleeps toward 1/CTRL_FREQ/k; with multiplier None, or a
    headless env, nothing sleeps."""
    env_func = partial(tmake, 'cartpole', device='cpu', seed=5, cost='quadratic',
                       task='traj_tracking', ctrl_freq=15, pyb_freq=750, episode_len_sec=2,
                       randomized_init=False, gui=True)
    ctrl = tmake('lqr', env_func, q_lqr=[1], r_lqr=[0.1])
    exp = BaseExperiment(env_func(), ctrl)
    sleeps = []
    monkeypatch.setattr(base_experiment.time, 'sleep', lambda s: sleeps.append(s))
    exp.run_evaluation(n_steps=5, visualization_time_multiplier=2, verbose=False)
    assert exp.visualization_time_multiplier == 2
    assert len(sleeps) >= 3
    assert all(0.0 <= s <= 1.0 / 15 / 2 + 1e-9 for s in sleeps)
    # The experiment's reset, the run's reset and five steps.
    assert exp.env.env._viewer.frame_count == 7
    sleeps.clear()
    exp.run_evaluation(n_steps=5, visualization_time_multiplier=None, verbose=False)
    assert sleeps == []
    exp.close()

    env_func2 = partial(tmake, 'cartpole', device='cpu', seed=5, cost='quadratic',
                        task='traj_tracking', ctrl_freq=15, pyb_freq=750, episode_len_sec=2,
                        randomized_init=False)
    ctrl2 = tmake('lqr', env_func2, q_lqr=[1], r_lqr=[0.1])
    exp2 = BaseExperiment(env_func2(), ctrl2)
    sleeps.clear()
    exp2.run_evaluation(n_steps=5, visualization_time_multiplier=1, verbose=False)
    assert sleeps == []
    exp2.close()


def test_mpc_run_collects_frames():
    env_func = partial(tmake, 'cartpole', device='cpu', seed=0, cost='quadratic',
                       ctrl_freq=15, pyb_freq=750, episode_len_sec=2, randomized_init=False,
                       init_state={'init_x': 0.2})
    ctrl = tmake('linear_mpc', env_func, q_mpc=[1], r_mpc=[0.1], horizon=10)
    ctrl.reset()
    res = ctrl.run(render=True, max_steps=3)
    assert len(res['frames']) == 3 == len(res['action'])
    assert all(f.dtype == np.uint8 and f.ndim == 3 for f in res['frames'])
    assert not np.array_equal(res['frames'][0], res['frames'][-1])
    assert ctrl.run(max_steps=2)['frames'] == []
    ctrl.close()
