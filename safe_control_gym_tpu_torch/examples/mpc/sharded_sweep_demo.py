"""Controller sweeps split over ranks: B independent solves, each rank its rows.

Port of ``examples/mpc/sharded_sweep_demo.py``. ``shard_over(mesh)`` splits
the B problems of the batched NMPC (``MPC.select_action_batch``) and of the
batched tube certification (``LinearMPSC.certify_action_batch``) over the
'data' axis of a ``parallel/sharding.Mesh``: each rank solves its rows, and
every rank gets the whole batch back (one gather), with no collective inside
the solves. On the card, one NCCL rank a GPU (in this process where there is
one GPU); with ``cpu``, ``R`` gloo ranks on the CPU (default 2):

    python -m safe_control_gym_tpu_torch.examples.mpc.sharded_sweep_demo [B]
    python -m safe_control_gym_tpu_torch.examples.mpc.sharded_sweep_demo cpu [B] [R]

(``--device cpu`` is ``cpu``.)

``main`` returns rank 0's figures: the NMPC actions and flags, the certified
actions and flags, the sweeps' seconds and the world's size.
"""

import datetime
import sys
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from safe_control_gym_tpu_torch.examples import demo_argv, synchronize
from safe_control_gym_tpu_torch.parallel.launch import free_port, spawn_local
from safe_control_gym_tpu_torch.parallel.sharding import make_env_mesh
from safe_control_gym_tpu_torch.utils.device import resolve_device
from safe_control_gym_tpu_torch.utils.registration import make

CFG = dict(seed=0, cost='quadratic', ctrl_freq=15, pyb_freq=750,
           randomized_init=False,
           task_info={'stabilization_goal': [0.0],
                      'stabilization_goal_tolerance': 0.01},
           constraints=[{'constraint_form': 'default_constraint',
                         'constrained_variable': 'state',
                         'upper_bounds': [1.5, 2, 0.3, 2],
                         'lower_bounds': [-1.5, -2, -0.3, -2]},
                        {'constraint_form': 'default_constraint',
                         'constrained_variable': 'input',
                         'upper_bounds': [5], 'lower_bounds': [-5]}])


NMPC = dict(q_mpc=[1], r_mpc=[0.1], horizon=10, sqp_iters=3, seed=0)
MPSC = dict(horizon=10, q_lin=[1], r_lin=[1], integration_algo='rk4', n_samples=120, tau=0.95,
            seed=0, use_terminal_set=False)


def sweep_inputs(B):
    """The sweep's states (B, 4) and actions to certify (B, 1)."""
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-0.3, 0.3, (B, 4)).astype(np.float32)
    return x0s, rng.uniform(-2, 2, (B, 1)).astype(np.float32)


def build_solvers(device):
    """The sweep's NMPC and its linear MPSC filter (learned), on ``device``."""
    env_func = partial(make, 'cartpole', device=device, **CFG)
    ctrl = make('mpc', env_func, **NMPC)
    ctrl.reset()
    sf = make('linear_mpsc', env_func, **MPSC)
    sf.learn()
    return ctrl, sf


def _timed(fn, device, *args):
    fn(*args)                 # first call: the ADMM stages' shapes
    synchronize(device)
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def sweep(B, device=None, solvers=None):
    """A rank's sweep over a 'data' mesh of every rank (``device``: this
    rank's; default the current CUDA device under NCCL, else the CPU), with
    ``solvers`` (``build_solvers``' pair on this rank's device) where given."""
    mesh = make_env_mesh(axis_name='data', device=device)
    ctrl, sf = build_solvers(mesh.device) if solvers is None else solvers
    ctrl.shard_over(mesh)
    sf.shard_over(mesh)
    x0s, acts = sweep_inputs(B)
    (u, feas), nmpc_s = _timed(ctrl.select_action_batch, mesh.device, x0s)
    (cert, ok), cert_s = _timed(sf.certify_action_batch, mesh.device, x0s, acts)
    return dict(u=u, feasible=feas, certified=cert, cert_feasible=ok, nmpc_seconds=nmpc_s,
                cert_seconds=cert_s, world=mesh.world_size)


def one_nccl_rank(B, solvers=None):
    """The sweep on a world of one NCCL rank, in this process."""
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{free_port()}', rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        return sweep(B, solvers=solvers)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """``argv`` (default ``sys.argv[1:]``): ``[B]`` on the GPUs, or ``cpu [B]
    [R]``."""
    args, device = demo_argv(sys.argv[1:] if argv is None else argv)
    on_cpu = (bool(args) and args[0] == 'cpu') or device == 'cpu'
    if args and args[0] == 'cpu':
        args = args[1:]
    if not on_cpu:
        resolve_device('cuda')
    B = int(args[0]) if args else 64
    if on_cpu:
        world = int(args[1]) if len(args) > 1 else 2
        res = spawn_local(sweep, world, backend='gloo', args=(B, 'cpu'), timeout=600)[0]
    elif torch.cuda.device_count() == 1:
        res = one_nccl_rank(B)
    else:
        world = torch.cuda.device_count()
        res = spawn_local(sweep, world, backend='nccl',
                          devices=[f'cuda:{i}' for i in range(world)], args=(B,),
                          timeout=600)[0]
    n = res['world']
    print(f'NMPC sweep: {B} solves over {n} ranks in {res["nmpc_seconds"]*1000:.0f} ms'
          f' -> {B/res["nmpc_seconds"]:.0f} solves/s, '
          f'{int(res["feasible"].sum())}/{B} feasible')
    print(f'certification sweep: {B} over {n} ranks in {res["cert_seconds"]*1000:.0f} ms '
          f'-> {B/res["cert_seconds"]:.0f} certs/s, {int(res["cert_feasible"].sum())}/{B} '
          'feasible')
    return res


if __name__ == '__main__':
    main()
