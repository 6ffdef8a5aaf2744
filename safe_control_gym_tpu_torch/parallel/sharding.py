"""Multi-GPU scaling over ``torch.distributed``: one rank a device, every rank the same calls.

Port of ``safe_control_gym_tpu/parallel/sharding.py``. The JAX package runs
one process over a ``jax.sharding.Mesh`` and lets XLA place the collectives.
The port runs one process (rank) a device, all of them through the same
calls (``torchrun --nproc_per_node=N`` or ``parallel/launch.spawn_local``),
and keeps JAX's contract: every rank gets the same inputs and returns the
whole outputs, and replicated state is identical on every rank.

* A ``Mesh`` holds the axis names, ``shape`` as a dict (``mesh.shape['env']``
  reads as in JAX), one process group an axis, this rank's coordinates and
  its device. The backend is the caller's (``'nccl'``, one rank a GPU;
  ``'gloo'`` on the CPU, or for ranks that share one GPU).
* The collectives are ``all_reduce`` and ``broadcast`` alone. A gather is the
  sum of a zero-filled buffer of the whole size into which each rank writes
  its own rows; adding zeros is exact.
* Random draws: a sharded controller keeps its one generator and draws every
  random tensor at the global width, then keeps its own rows. A W-rank run's
  envs are then rows of the one-process run's envs, as under JAX's one key.
* Tensor parallelism (``mlp_tp_shardings``): Megatron's split of an MLP. A
  column-parallel layer keeps ``out / n_model`` columns and their bias; the
  next, row-parallel, layer sums its partial products over the model axis in
  the forward pass (and passes the gradient through in the backward); a
  column-parallel input takes the sum of its gradient in the backward pass.
  A ``TPMLP`` is such a layer list; ``math/networks.mlp_apply`` runs it.

    dist.init_process_group('nccl', ...)           # or spawn_local / torchrun
    mesh = make_env_mesh()                         # every rank on one 'env' axis
    ctrl.shard_over(mesh)                          # PPO, SAC, RARL, RAP
    mesh = make_dp_tp_mesh(n_model=2)              # ('env', 'model')
    ctrl.shard_over(mesh, model_axis='model')      # PPO, SAC
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from safe_control_gym_tpu_torch.math.networks import ACTIVATIONS

__all__ = ['Mesh', 'AxisSum', 'EnvShards', 'make_env_mesh', 'make_dp_tp_mesh',
           'shard_env_batch', 'replicate', 'make_sharded_env_step', 'make_dp_train_step',
           'mlp_tp_shardings',
           'actor_critic_tp_shardings', 'take_rows', 'TPMLP', 'shard_params',
           'gather_params', 'leaf_dims', 'shard_adam',
           'gather_adam', 'tp_sq_norm', 'batch_split']


def _world_size(n_devices=None):
    """The world's size, which ``n_devices`` (where given) must be: each rank
    is one device."""
    if not dist.is_initialized():
        raise RuntimeError('a mesh needs torch.distributed.init_process_group first '
                           '(torchrun, or parallel/launch.spawn_local)')
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f'a mesh of {n_devices} devices: the world has {world} ranks')
    return world


class Mesh:
    """A grid of the ranks, row major over ``axes`` (outermost first): each
    axis's process group, this rank's coordinates and its device."""

    def __init__(self, axes, device=None):
        _world_size()
        self.axis_names = tuple(name for name, _ in axes)
        self.shape = {name: int(size) for name, size in axes}
        sizes = [self.shape[n] for n in self.axis_names]
        self.rank, self.world_size = dist.get_rank(), dist.get_world_size()
        if int(np.prod(sizes)) != self.world_size:
            raise ValueError(f'mesh {self.shape} does not cover the world of '
                             f'{self.world_size} ranks')
        backend = dist.get_backend()
        if device is None:
            device = (torch.device('cuda', torch.cuda.current_device()) if backend == 'nccl'
                      else torch.device('cpu'))
        self.device = torch.device(device)
        if self.device.type == 'cuda' and self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        if backend == 'nccl' and self.device.type != 'cuda':
            raise ValueError(f'the nccl backend needs CUDA tensors, not {self.device}')
        grid = np.arange(self.world_size).reshape(sizes)
        self.coords = {n: int(c) for n, c in
                       zip(self.axis_names, np.unravel_index(self.rank, sizes))}
        self.groups, self.group_ranks = {}, {}
        for i, name in enumerate(self.axis_names):
            # Every rank makes every group, in one order.
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[name], self.group_ranks[name] = group, ranks

    def __repr__(self):
        return f'Mesh({self.shape}, rank={self.rank}, device={self.device})'

    def check_device(self, device):
        """Raise unless ``device`` (a controller's; ``'cuda'`` is the current
        CUDA device) is this rank's device."""
        dev = torch.device(device)
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        if dev != self.device:
            raise ValueError(f'rank {self.rank} runs on {self.device}, but the controller '
                             f'is on {dev}')

    def rows(self, n: int, axis: str):
        """``(lo, hi)``: this rank's rows of ``n`` split over ``axis``."""
        size = self.shape[axis]
        if n % size != 0:
            raise ValueError(f'a batch of {n} does not divide over the {size} ranks of '
                             f'the {axis!r} mesh axis')
        per = n // size
        return self.coords[axis] * per, (self.coords[axis] + 1) * per

    def psum(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axis`` (a name or a tuple of
        names), as a new tensor."""
        out = t.clone(memory_format=torch.contiguous_format)
        for name in ((axis,) if isinstance(axis, str) else axis):
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.groups[name])
        return out

    def broadcast_(self, tensors, axis: Optional[str] = None):
        """Copy the first rank's ``tensors`` (of ``axis``'s group, or of the
        world) into every rank's, in place."""
        group = None if axis is None else self.groups[axis]
        src = 0 if axis is None else self.group_ranks[axis][0]
        for t in tensors:
            # NCCL takes contiguous tensors only (a transposed init is not).
            buf = t if t.is_contiguous() else t.contiguous()
            dist.broadcast(buf, src=src, group=group)
            if buf is not t:
                t.copy_(buf)

    def gather_rows(self, local: torch.Tensor, n: int, axis: str) -> torch.Tensor:
        """The (n, ...) tensor whose rows split over ``axis`` are each rank's
        ``local`` rows."""
        lo, hi = self.rows(n, axis)
        dtype = local.dtype
        work = torch.uint8 if dtype == torch.bool else dtype
        full = torch.zeros((n,) + tuple(local.shape[1:]), dtype=work, device=self.device)
        full[lo:hi] = local.to(device=self.device, dtype=work)
        return self.psum(full, axis).to(dtype)


class AxisSum:
    """``mesh.psum`` over one axis as a callable, with ``n``, the axis's
    size: the ``psum`` that ``math/normalization.rms_update`` takes."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh, self.axis, self.n = mesh, axis, mesh.shape[axis]

    def __call__(self, t):
        return self.mesh.psum(t, self.axis)

    def mean(self, x):
        """The mean of ``x`` over every rank's elements (each rank's ``x`` of
        one shape)."""
        return self(x.sum()) / (x.numel() * self.n)

    def sum(self, x):
        return self(x.sum())


def make_env_mesh(n_devices: Optional[int] = None, axis_name: str = 'env',
                  device=None) -> Mesh:
    """A 1-D mesh of every rank over the env/data axis."""
    return Mesh([(axis_name, _world_size(n_devices))], device)


def make_dp_tp_mesh(n_model: int = 2, n_devices: Optional[int] = None, env_axis: str = 'env',
                    model_axis: str = 'model', device=None) -> Mesh:
    """A 2-D mesh: data ('env') by tensor ('model') parallel, the model axis
    innermost (neighbouring ranks), as in JAX's grid."""
    world = _world_size(n_devices)
    if world % n_model != 0:
        raise ValueError(f'{world} ranks do not split into model groups of {n_model}')
    return Mesh([(env_axis, world // n_model), (model_axis, n_model)], device)


def take_rows(tree, lo: int, hi: int):
    """Rows ``lo:hi`` of every tensor or array of ``tree`` (dataclasses,
    dicts, lists, tuples) with a leading axis; 0-d leaves (shared parameters)
    stay as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree[lo:hi] if tree.ndim else tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: take_rows(getattr(tree, f.name), lo, hi)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: take_rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_rows(v, lo, hi) for v in tree)
    return tree


def gather_tree_rows(mesh: Mesh, tree, n: int, axis: str):
    """``take_rows``'s inverse: every rank's rows of every batched leaf of
    ``tree`` put together into the whole batch of ``n``."""
    if isinstance(tree, torch.Tensor):
        return mesh.gather_rows(tree, n, axis) if tree.ndim else tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: gather_tree_rows(mesh, getattr(tree, f.name), n, axis)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: gather_tree_rows(mesh, v, n, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree_rows(mesh, v, n, axis) for v in tree)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def shard_env_batch(mesh: Mesh, states, axis_name: str = 'env'):
    """This rank's rows of a batched ``EnvState`` (or any pytree of batched
    tensors) that every rank holds whole."""
    n = next(t for t in _tensors(states) if t.ndim).shape[0]
    return take_rows(states, *mesh.rows(n, axis_name))


def replicate(mesh: Mesh, pytree):
    """Every tensor of ``pytree`` set to rank 0's value, in place; returns
    ``pytree``."""
    mesh.broadcast_(_tensors(pytree))
    return pytree


def make_sharded_env_step(mesh: Mesh, func_env, axis_name: str = 'env'):
    """``(reset_fn(gen, n), step_fn(states, actions, gen))``: the rank's rows
    of ``func_env.reset_batch`` and of ``func_env.step_autoreset``. Both draw
    at the global width and keep the rank's rows, so the envs are rows of the
    one-process run's; on the card each step is one K1, K2 or K3 launch for
    the rank's envs."""

    def reset_fn(gen, n):
        return take_rows(func_env.reset_batch(gen, n), *mesh.rows(n, axis_name))

    def step_fn(states, actions, gen):
        n = states.state.shape[0] * mesh.shape[axis_name]
        lo, hi = mesh.rows(n, axis_name)
        drawn = take_rows(func_env.draw_noise(gen, n), lo, hi)
        fresh = take_rows(func_env.reset_batch(gen, n), lo, hi)
        return func_env.step_autoreset(states, actions, None, drawn=drawn, fresh=fresh)

    return reset_fn, step_fn


def make_dp_train_step(mesh: Mesh, update_fn: Callable, axis_name: str = 'env'):
    """A data-parallel step ``run(params, batch)``: each rank holds its rows
    of ``batch`` (a pytree of batched tensors); the rows are gathered and
    ``update_fn(params, batch)`` runs on every rank on rank 0's params,
    which gives the one-device result on every rank."""

    def run(params, batch):
        params = replicate(mesh, params)
        n = next(t for t in _tensors(batch) if t.ndim).shape[0] * mesh.shape[axis_name]
        return update_fn(params, gather_tree_rows(mesh, batch, n, axis_name))

    return run


class EnvShards:
    """A sharded controller's envs: this rank's rows ``lo:hi`` of the N envs
    split over ``axis`` of ``mesh``, the sum over that axis (``psum``), the
    env step of the rank's rows drawn at the global width (``step``), and
    the maps of an update batch's rows to this rank's (``batch_rows``)."""

    def __init__(self, mesh: Mesh, axis: str, n: int, device):
        mesh.check_device(device)
        self.mesh, self.axis, self.n, self.device = mesh, axis, n, torch.device(device)
        self.lo, self.hi = mesh.rows(n, axis)
        self.draw_rows = (self.lo, self.hi, n)
        self.psum = AxisSum(mesh, axis)

    def take(self, tree):
        """This rank's rows of a pytree of the whole N-env batch."""
        return take_rows(tree, self.lo, self.hi)

    def gather(self, tree):
        """The whole N-env batch of a pytree of this rank's rows."""
        return gather_tree_rows(self.mesh, tree, self.n, self.axis)

    def step(self, func_env, est, act, gen):
        """``func_env.step_autoreset`` of this rank's envs, drawn at the
        global width (``make_sharded_env_step``)."""
        return make_sharded_env_step(self.mesh, func_env, self.axis)[1](est, act, gen)

    def batch_rows(self, t: int, cols=None):
        """The (t len(cols),) map of the rows of a (t, len(cols)) batch of the
        envs ``cols`` (all N by default), flattened step-major, to this rank's
        rows of it (-1 where another rank holds the row). With ``cols``, also
        this rank's columns of the (t, N/W) local tensors that make its rows."""
        cols = torch.arange(self.n, device=self.device) if cols is None else cols
        mine = (cols >= self.lo) & (cols < self.hi)
        q = torch.cumsum(mine.to(torch.int64), 0) - 1
        n_mine = int(mine.sum())
        steps = torch.arange(t, device=self.device)[:, None] * n_mine
        rows = torch.where(mine[None, :], steps + q[None, :], torch.full_like(steps, -1))
        return rows.reshape(-1), cols[mine] - self.lo


# -- tensor parallelism -------------------------------------------------------

def mlp_tp_shardings(mesh: Mesh, params, model_axis: str = 'model'):
    """Megatron shardings of an ``mlp_init`` list, as JAX's: per layer
    ``{'w': spec, 'b': spec}``, a spec being the partition of the tensor's
    dims (``(None, model_axis)`` splits a weight's columns). Column- and
    row-parallel layers alternate; a layer whose outputs do not divide over
    the axis (a one-action head) stays replicated."""
    col = {'w': (None, model_axis), 'b': (model_axis,)}
    row = {'w': (model_axis, None), 'b': ()}
    repl = {'w': (), 'b': ()}
    n_shards = mesh.shape[model_axis]
    out, feat_sharded = [], False
    for layer in params:
        out_dim = layer['w'].shape[1]
        if feat_sharded:
            out.append(row)
            feat_sharded = False
        elif out_dim % n_shards == 0 and out_dim >= n_shards:
            out.append(col)
            feat_sharded = True
        else:
            out.append(repl)
    return out


def actor_critic_tp_shardings(mesh: Mesh, params, model_axis: str = 'model'):
    """``mlp_tp_shardings`` of each MLP of a parameter dict (PPO's actor and
    critic, SAC's actor and twin Q); other entries replicated (``()``)."""
    return {k: (mlp_tp_shardings(mesh, v, model_axis) if isinstance(v, (list, tuple)) else ())
            for k, v in params.items()}


def _dim(spec, axis):
    return spec.index(axis) if axis in spec else None


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis backward
    (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axis), None, None


class _FromModel(torch.autograd.Function):
    """The partial products of a row-parallel layer summed over the model
    axis forward; the gradient passed through backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherCols(torch.autograd.Function):
    """A column-parallel output put together whole forward; this rank's
    columns of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        n = mesh.shape[axis]
        k = x.shape[-1]
        ctx.cols = (mesh.coords[axis] * k, (mesh.coords[axis] + 1) * k)
        full = x.new_zeros(x.shape[:-1] + (k * n,))
        full[..., ctx.cols[0]:ctx.cols[1]] = x
        return mesh.psum(full, axis)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.cols[0]:ctx.cols[1]], None, None


class TPMLP(list):
    """An ``mlp_init`` layer list holding this rank's shards under ``specs``
    (``mlp_tp_shardings``); ``apply`` is the forward pass with the model
    axis's collectives. ``math/optim.tree_unflatten`` keeps the type."""

    def __init__(self, layers, mesh: Mesh, axis: str, specs):
        super().__init__(layers)
        self.mesh, self.axis, self.specs = mesh, axis, specs

    def rebuild(self, layers):
        return TPMLP(layers, self.mesh, self.axis, self.specs)

    def dims(self):
        """The split dim of each leaf (or None), in ``tree_leaves`` order."""
        return [_dim(spec[k], self.axis) for spec in self.specs for k in sorted(spec)]

    def apply(self, x, activation='tanh', out_activation='identity'):
        act, out_act = ACTIVATIONS[activation], ACTIVATIONS[out_activation]
        mesh, axis, last = self.mesh, self.axis, len(self) - 1
        h = x
        for i, (layer, spec) in enumerate(zip(self, self.specs)):
            if _dim(spec['w'], axis) == 1:            # column-parallel
                h = torch.matmul(_ToModel.apply(h, mesh, axis), layer['w']) + layer['b']
                if i == last:
                    h = _GatherCols.apply(h, mesh, axis)
            elif _dim(spec['w'], axis) == 0:          # row-parallel
                h = _FromModel.apply(torch.matmul(h, layer['w']), mesh, axis) + layer['b']
            else:
                h = torch.matmul(h, layer['w']) + layer['b']
            h = act(h) if i < last else out_act(h)
        return h


def _split(t, dim, mesh, axis):
    if dim is None:
        return t
    return t.chunk(mesh.shape[axis], dim)[mesh.coords[axis]].contiguous()


def _join(t, dim, mesh, axis):
    if dim is None:
        return t
    n, i = mesh.shape[axis], mesh.coords[axis]
    shape = list(t.shape)
    k = shape[dim]
    shape[dim] = k * n
    full = t.new_zeros(shape)
    full.narrow(dim, i * k, k).copy_(t)
    return mesh.psum(full, axis)


def shard_params(mesh: Mesh, params, specs, model_axis: str = 'model'):
    """``params`` with each MLP replaced by the ``TPMLP`` of this rank's
    shards under ``specs`` (``actor_critic_tp_shardings``)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, (list, tuple)):
            out[k] = TPMLP([{n: _split(layer[n], _dim(spec[n], model_axis), mesh, model_axis)
                             for n in layer} for layer, spec in zip(v, specs[k])],
                           mesh, model_axis, specs[k])
        else:
            out[k] = v
    return out


def gather_params(tree):
    """``tree`` with every ``TPMLP`` put back together as a plain list of
    whole tensors (a collective over its model axis)."""
    if isinstance(tree, TPMLP):
        return [{n: _join(layer[n], _dim(spec[n], tree.axis), tree.mesh, tree.axis)
                 for n in layer} for layer, spec in zip(tree, tree.specs)]
    if isinstance(tree, dict):
        return {k: gather_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_params(v) for v in tree)
    return tree


def leaf_dims(tree):
    """The split dim of each leaf of ``tree`` (None where whole), in
    ``math/optim.tree_leaves`` order."""
    if isinstance(tree, TPMLP):
        return tree.dims()
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in leaf_dims(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [d for v in tree for d in leaf_dims(v)]
    return [None]


def shard_adam(mesh: Mesh, axis: str, state, tree):
    """An Adam state (``math/optim.py``) over the whole leaves of ``tree``
    (already split, with ``TPMLP``s) with its moments split as the leaves."""
    dims = leaf_dims(tree)
    return {'count': state['count'],
            **{k: [_split(t, d, mesh, axis) for t, d in zip(state[k], dims)]
               for k in ('mu', 'nu')}}


def gather_adam(mesh: Mesh, axis: str, state, tree):
    """``shard_adam``'s inverse: the moments gathered whole."""
    dims = leaf_dims(tree)
    return {'count': state['count'],
            **{k: [_join(t, d, mesh, axis) for t, d in zip(state[k], dims)]
               for k in ('mu', 'nu')}}


def tp_sq_norm(mesh: Mesh, axis: str, leaves, dims) -> torch.Tensor:
    """The squared global norm of tensors split under ``dims``: the split
    leaves' squares summed over the model axis, the whole ones counted once."""
    split = sum(torch.sum(t * t) for t, d in zip(leaves, dims) if d is not None)
    whole = sum(torch.sum(t * t) for t, d in zip(leaves, dims) if d is None)
    split = mesh.psum(torch.as_tensor(split, dtype=torch.float32, device=mesh.device), axis)
    return split + whole


# -- batch-split solvers ------------------------------------------------------

def batch_split(n_rows: int = 1):
    """Decorate a batch method whose first ``n_rows`` arguments are arrays of
    B rows and whose result is an array of B rows or a tuple of them. After
    ``shard_over(mesh, axis_name)`` (which sets ``_solve_mesh`` and
    ``_solve_mesh_axis``), each rank solves its rows ``[r B/W, (r+1) B/W)``
    and every rank returns the whole batch; a B that does not divide over
    the axis raises ValueError."""

    def deco(method):
        @functools.wraps(method)
        def wrapper(self, *args, **kwargs):
            mesh = getattr(self, '_solve_mesh', None)
            if mesh is None:
                return method(self, *args, **kwargs)
            axis = self._solve_mesh_axis
            rows = [np.atleast_2d(np.asarray(a)) for a in args[:n_rows]]
            n = rows[0].shape[0]
            lo, hi = mesh.rows(n, axis)
            out = method(self, *[r[lo:hi] for r in rows], *args[n_rows:], **kwargs)
            whole = lambda a: mesh.gather_rows(torch.as_tensor(np.asarray(a)), n,
                                               axis).cpu().numpy()
            return tuple(whole(a) for a in out) if isinstance(out, tuple) else whole(out)
        return wrapper
    return deco
