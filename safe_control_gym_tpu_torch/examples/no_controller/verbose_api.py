"""A tour of an env's API: spaces, the prior model, constraints and one step.

Port of ``examples/no_controller/verbose_api.py``. It prints what the JAX
package's script prints and returns the printed arrays:

    python -m safe_control_gym_tpu_torch.examples.no_controller.verbose_api --task cartpole \\
        --overrides examples/no_controller/config_overrides/verbose_api_cartpole.yaml
"""

from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, 'detach') else np.asarray(t)


def run():
    config = ConfigFactory().merge()
    env = partial(make, config.task, device=config.device, **config.task_config)()
    obs, info = env.reset()

    print('OBSERVATION SPACE:', env.observation_space)
    print('ACTION SPACE:', env.action_space)
    print('STATE SPACE:', env.state_space)
    print('PHYSICAL ACTION BOUNDS:', env.physical_action_bounds)
    print('X_GOAL shape:', np.shape(env.X_GOAL))
    print('U_GOAL:', env.U_GOAL)

    model = env.symbolic
    out = {}
    print('\n--- ANALYTIC (symbolic-equivalent) MODEL ---')
    print('nx, nu, ny:', model.nx, model.nu, model.ny)
    print('dt:', model.dt)
    x = np.zeros(model.nx)
    u = np.atleast_1d(env.U_GOAL)[:model.nu] if np.ndim(env.U_GOAL) else np.zeros(model.nu)
    u = np.asarray(u, dtype=np.float32).reshape(model.nu)
    out['fc'] = _np(model.fc_func(x, u))
    out['fd'] = _np(model.fd_func(x, u))
    print('fc_func(x0, u0):', out['fc'])
    print('fd_func(x0, u0):', out['fd'])
    df = model.df_func(x, u)
    out['dfdx'], out['dfdu'] = _np(df['dfdx']), _np(df['dfdu'])
    print('dfdx:\n', out['dfdx'])
    print('dfdu:\n', out['dfdu'])
    loss = model.loss(x=x, u=u, Xr=np.zeros(model.nx), Ur=np.zeros(model.nu),
                      Q=np.eye(model.nx), R=np.eye(model.nu))
    out['l'], out['l_x'] = float(_np(loss['l'])), _np(loss['l_x'])
    print('loss l:', out['l'])
    print('loss l_x:', out['l_x'])

    if env.constraints is not None:
        print('\n--- CONSTRAINTS ---')
        print('num_constraints:', env.constraints.num_constraints)
        out['constraint_values'] = env.constraints.get_values(env, only_state=True)
        print('values at reset:', out['constraint_values'])

    print('\n--- STEP OUTPUT ---')
    obs, reward, done, step_info = env.step(u)
    out.update(obs=obs, reward=reward, done=done)
    print('obs:', obs)
    print('reward:', reward)
    print('done:', done)
    print('info:', step_info)
    env.close()
    return out


if __name__ == '__main__':
    run()
