"""The rollout kernels' parameter vectors, worked out from a configuration
file alone.

The program derives the (40,) cartpole and (105,) quadrotor float32 vectors
from its env objects; the reference derives them again here from the
configuration's published keys and the systems' physical constants (the
cartpole's defaults and the CF2X's, as the reference environment states
them), so that it takes nothing the program made. A test holds these vectors
to the program's at small size on the CPU.
"""

from __future__ import annotations

import math

import numpy as np


def _layout(names):
    out, off = {}, 0
    for name, size in names:
        out[name] = off
        off += size
    return out, off


CARTPOLE_LAYOUT, CARTPOLE_LEN = _layout([
    ('POLE_MASS', 1), ('CART_MASS', 1), ('POLE_LEN', 1), ('GRAVITY', 1), ('ACT_LO', 1),
    ('ACT_HI', 1), ('ACT_SCALE', 1), ('PHYS_LO', 1), ('PHYS_HI', 1), ('GOAL', 4),
    ('TOL_SQ', 1), ('X_THRESH', 1), ('TH_THRESH', 1), ('MAX_STEPS', 1), ('W_ACT', 1),
    ('NOISE_STD', 1), ('INIT_LO', 4), ('INIT_HI', 4), ('W_STATE', 4), ('CON_HI', 4),
    ('P_STD', 4), ('U_GOAL', 1)])

QUAD_LAYOUT, QUAD_LEN = _layout([
    ('MASS', 1), ('IXX', 1), ('IYY', 1), ('IZZ', 1), ('ARM_L', 1), ('GRAVITY', 1),
    ('KF', 1), ('KM', 1), ('PWM_SCALE', 1), ('PWM_CONST', 1), ('PWM_MIN', 1),
    ('PWM_MAX', 1), ('ACT_LO', 1), ('ACT_HI', 1), ('DEN_A', 1), ('DEN_B', 1),
    ('PHYS_LO', 1), ('PHYS_HI', 1), ('GOAL', 12), ('TOL_SQ', 1), ('MAX_STEPS', 1),
    ('U_GOAL', 4), ('W_ACT', 4), ('NOISE_STD', 1), ('W_STATE', 12), ('INIT_LO', 12),
    ('INIT_HI', 12), ('CON_LO', 12), ('CON_HI', 12), ('P_STD', 4)])

# The cartpole's defaults (pole mass, cart mass, effective pole length,
# gravity; the force scale; the bounds; the init randomization).
CARTPOLE = dict(pole_mass=0.1, cart_mass=1.0, pole_length=0.5, gravity=9.8,
                action_scale=10.0, x_threshold=2.4, x_dot_threshold=20.0,
                theta_threshold=90 * math.pi / 180, theta_dot_threshold=20.0,
                init_rand={k: {'distrib': 'uniform', 'low': -0.05, 'high': 0.05}
                           for k in ('init_x', 'init_x_dot', 'init_theta',
                                     'init_theta_dot')})
CARTPOLE_LABELS = ('init_x', 'init_x_dot', 'init_theta', 'init_theta_dot')

# The CF2X quadrotor (cf2x.urdf): mass, inertia, arm, thrust and torque
# coefficients, the PWM-RPM map and its range; the state box.
CF2X = dict(mass=0.027, Ixx=1.4e-5, Iyy=1.4e-5, Izz=2.17e-5, arm=0.0397, gravity=9.8,
            kf=3.16e-10, km=7.94e-12, pwm2rpm_scale=0.2685, pwm2rpm_const=4070.3,
            min_pwm=20000.0, max_pwm=65535.0, ground_z=-0.05)
QUAD3D_LABELS = ('init_x', 'init_x_dot', 'init_y', 'init_y_dot', 'init_z', 'init_z_dot',
                 'init_phi', 'init_theta', 'init_psi', 'init_p', 'init_q', 'init_r')


def _ctrl_steps(task):
    return int(task.get('episode_len_sec', 5) * int(task.get('ctrl_freq', 50)))


def substeps(task):
    """(substeps a control step, physics timestep) of a task config."""
    ctrl, pyb = int(task.get('ctrl_freq', 50)), int(task.get('pyb_freq', 1000))
    return int(pyb / ctrl), 1.0 / pyb


def _init_box(nominal, labels, task, default_rand):
    lo, hi = nominal.copy(), nominal.copy()
    if task.get('randomized_init', True):
        rand = task.get('init_state_randomization_info') or default_rand
        for k, name in enumerate(labels):
            info = rand.get(name)
            if info is None:
                continue
            if info.get('distrib') != 'uniform':
                raise ValueError('reference: uniform init randomization only')
            lo[k] += info['low']
            hi[k] += info['high']
    return lo, hi


def _weights(v, n):
    v = np.atleast_1d(np.asarray(v, float))
    return v if v.size == n else np.full(n, v[0])


def cartpole_cfg(task: dict, noise_std: float = 0.0) -> np.ndarray:
    """The (40,) float32 K4 vector of a cartpole stabilization task with the
    RL reward."""
    p = CARTPOLE
    cfg = np.zeros(CARTPOLE_LEN, np.float32)
    L = CARTPOLE_LAYOUT
    normalized = task.get('normalized_rl_action_space', False)
    cfg[L['POLE_MASS']], cfg[L['CART_MASS']] = p['pole_mass'], p['cart_mass']
    cfg[L['POLE_LEN']], cfg[L['GRAVITY']] = p['pole_length'], p['gravity']
    threshold = 1 if normalized else p['action_scale']
    cfg[L['ACT_LO']], cfg[L['ACT_HI']] = -threshold, threshold
    cfg[L['ACT_SCALE']] = p['action_scale'] if normalized else 1.0
    cfg[L['PHYS_LO']], cfg[L['PHYS_HI']] = -p['action_scale'], p['action_scale']
    info = task.get('task_info', {})
    cfg[L['GOAL']:L['GOAL'] + 4] = [info.get('stabilization_goal', [0])[0], 0.0, 0.0, 0.0]
    tol = float(info.get('stabilization_goal_tolerance', 0.05))
    cfg[L['TOL_SQ']] = tol * tol
    cfg[L['X_THRESH']], cfg[L['TH_THRESH']] = p['x_threshold'], p['theta_threshold']
    cfg[L['MAX_STEPS']] = _ctrl_steps(task)
    cfg[L['W_ACT']] = _weights(task.get('rew_act_weight', 0.0001), 1)[0]
    cfg[L['W_STATE']:L['W_STATE'] + 4] = _weights(task.get('rew_state_weight', 1.0), 4)
    init = task.get('init_state') or {}
    nominal = np.array([init.get(k, 0.0) for k in CARTPOLE_LABELS], np.float32)
    lo, hi = _init_box(nominal, CARTPOLE_LABELS, task, p['init_rand'])
    cfg[L['INIT_LO']:L['INIT_LO'] + 4] = lo
    cfg[L['INIT_HI']:L['INIT_HI'] + 4] = hi
    bound = np.array([p['x_threshold'] * 2, p['x_dot_threshold'], p['theta_threshold'] * 2,
                      p['theta_dot_threshold']]).astype(np.float32)
    cfg[L['CON_HI']:L['CON_HI'] + 4] = bound
    cfg[L['NOISE_STD']] = noise_std
    return cfg


def quad3d_box():
    """(low, high) float32 of the 3D quadrotor's state box."""
    deg = math.pi / 180
    hi = np.array([2, 30, 2, 30, 2, 30, 85 * deg, 85 * deg, 180 * deg,
                   500 * deg, 500 * deg, 500 * deg])
    lo = -hi
    lo[4] = CF2X['ground_z']
    return lo.astype(np.float32), hi.astype(np.float32)


def quad3d_hover_thrust(task: dict = None) -> float:
    return CF2X['gravity'] * CF2X['mass'] / 4


def quad3d_cfg(task: dict, noise_std: float = 0.0) -> np.ndarray:
    """The (105,) float32 K5 vector of a 3D quadrotor stabilization task with
    the RL reward."""
    q = CF2X
    cfg = np.zeros(QUAD_LEN, np.float32)
    L = QUAD_LAYOUT
    normalized = task.get('normalized_rl_action_space', False)
    a_low = q['kf'] * 1.0 * (q['pwm2rpm_scale'] * q['min_pwm'] + q['pwm2rpm_const']) ** 2
    a_high = q['kf'] * 1.0 * (q['pwm2rpm_scale'] * q['max_pwm'] + q['pwm2rpm_const']) ** 2
    hover = quad3d_hover_thrust(task)
    info = task.get('task_info', {})
    tol = float(info.get('stabilization_goal_tolerance', 0.0))
    for name, val in (('MASS', q['mass']), ('IXX', q['Ixx']), ('IYY', q['Iyy']),
                      ('IZZ', q['Izz']), ('ARM_L', q['arm']), ('GRAVITY', q['gravity']),
                      ('KF', q['kf']), ('KM', q['km']), ('PWM_SCALE', q['pwm2rpm_scale']),
                      ('PWM_CONST', q['pwm2rpm_const']), ('PWM_MIN', q['min_pwm']),
                      ('PWM_MAX', q['max_pwm']),
                      ('ACT_LO', -1.0 if normalized else np.float32(a_low)),
                      ('ACT_HI', 1.0 if normalized else np.float32(a_high)),
                      ('PHYS_LO', np.float32(a_low)), ('PHYS_HI', np.float32(a_high)),
                      ('TOL_SQ', tol ** 2), ('MAX_STEPS', _ctrl_steps(task))):
        cfg[L[name]] = val
    if normalized:
        cfg[L['DEN_A']] = task.get('norm_act_scale', 0.1) * hover
        cfg[L['DEN_B']] = hover
    else:
        cfg[L['DEN_A']] = 1.0
    goal = info.get('stabilization_goal', [0, 0, 1])
    cfg[L['GOAL']:L['GOAL'] + 12] = [goal[0], 0.0, goal[1], 0.0, goal[2], 0.0,
                                     0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    cfg[L['U_GOAL']:L['U_GOAL'] + 4] = np.ones(4) * q['mass'] * q['gravity'] / 4
    cfg[L['W_ACT']:L['W_ACT'] + 4] = _weights(task.get('rew_act_weight', 0.0001), 4)
    cfg[L['W_STATE']:L['W_STATE'] + 12] = _weights(task.get('rew_state_weight', 1.0), 12)
    init = task.get('init_state') or {}
    nominal = np.array([float(init.get(k, 0.0)) for k in QUAD3D_LABELS], np.float32)
    lo, hi = _init_box(nominal, QUAD3D_LABELS, task, None)
    cfg[L['INIT_LO']:L['INIT_LO'] + 12] = lo
    cfg[L['INIT_HI']:L['INIT_HI'] + 12] = hi
    box_lo, box_hi = quad3d_box()
    cfg[L['CON_LO']:L['CON_LO'] + 12] = box_lo
    cfg[L['CON_HI']:L['CON_HI'] + 12] = box_hi
    cfg[L['NOISE_STD']] = noise_std
    return cfg


CFGS = {'cartpole': cartpole_cfg, 'quadrotor_3D': quad3d_cfg}
