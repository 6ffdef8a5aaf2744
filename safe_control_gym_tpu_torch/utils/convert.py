"""State carried across from the JAX package: its pytrees, given as numpy, to the port's types.

The tests start both packages from one state this way. A JAX ``EnvState`` of a
batch is passed as a dict of numpy arrays (``state``, ``ctrl_step``, the
``dyn_params`` fields as a dict, ``dist_obs``, ``dist_act``, ``dist_dyn``); its
PRNG ``key`` has no counterpart (the port takes ``torch.Generator``\\ s) and is
ignored; the adversary buffers (``adv_action``, ``adv_valid``) carry across.
The parameter type follows the fields: ``mass`` makes ``QuadParams``, else
``CartPoleParams``. A field that holds one value for the whole batch becomes
a shared 0-d tensor, one that varies over the batch (randomized inertial
properties) a (B,) tensor.

An RL actor's parameters (``mlp_init`` layout, a list of ``{'w', 'b'}``) and a
frozen observation normalizer carry across as copies. PPO's training state
does too: the return normalizer (``RetState``) and the optax Adam state of
each optimizer (``count``, ``mu``, ``nu``; read from a JAX checkpoint by
``utils/checkpoint.py``'s unpickler, after ``plain``). The ``*_to_numpy``
functions give the port's states back as numpy, the layout of the port's
own checkpoints. So do the off-policy learners' replay rings
(``replay_from_numpy``) and any parameter pytree of dicts and lists
(``tree_from_numpy``, ``tree_to_numpy``).
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from safe_control_gym_tpu_torch.envs.benchmark_env import EnvState
from safe_control_gym_tpu_torch.envs.dynamics import CartPoleParams, QuadParams
from safe_control_gym_tpu_torch.math.normalization import NormalizerState, RetState
from safe_control_gym_tpu_torch.math.optim import tree_leaves, tree_unflatten
from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['cartpole_params_from_numpy', 'quad_params_from_numpy',
           'env_state_from_numpy', 'env_state_to_numpy', 'mlp_params_from_numpy',
           'normalizer_from_numpy', 'normalizer_to_numpy', 'ret_state_from_numpy',
           'adam_state_from_numpy', 'adam_state_to_numpy', 'tree_from_numpy', 'tree_to_numpy',
           'replay_from_numpy', 'replay_to_numpy']


def _params_from_numpy(cls, d, device):
    """``cls`` from a dict of numpy scalars or per-env arrays, one entry per
    field: a 0-d tensor where the field holds one value, else (B,)."""
    dev = resolve_device(device)
    out = {}
    for f in fields(cls):
        v = np.asarray(d[f.name], np.float32).ravel()
        if v.size == 0:
            raise ValueError(f'{f.name}: an empty parameter array')
        out[f.name] = torch.tensor(v[0] if np.all(v == v[0]) else v, dtype=torch.float32,
                                   device=dev)
    return cls(**out)


def cartpole_params_from_numpy(d, device='cuda') -> CartPoleParams:
    """``CartPoleParams`` from a dict of numpy scalars or per-env arrays."""
    return _params_from_numpy(CartPoleParams, d, device)


def quad_params_from_numpy(d, device='cuda') -> QuadParams:
    """``QuadParams`` from a dict of numpy scalars or per-env arrays."""
    return _params_from_numpy(QuadParams, d, device)


def env_state_from_numpy(d, device='cuda') -> EnvState:
    """The port's batched ``EnvState`` from a JAX ``EnvState`` given as a dict
    of numpy arrays."""
    dev = resolve_device(device)
    # torch.tensor copies: arrays read from JAX are not writable.
    state = torch.tensor(np.asarray(d['state'], np.float32), device=dev)
    n = state.shape[0]
    f32 = lambda k: torch.tensor(np.asarray(d[k], np.float32).reshape(n, -1),
                                 device=dev)
    params = (quad_params_from_numpy if 'mass' in d['dyn_params']
              else cartpole_params_from_numpy)
    return EnvState(
        state=state,
        ctrl_step=torch.tensor(np.asarray(d['ctrl_step'], np.int32), device=dev),
        dyn_params=params(d['dyn_params'], dev),
        dist_obs=f32('dist_obs'), dist_act=f32('dist_act'),
        dist_dyn=f32('dist_dyn'),
        adv_action=(f32('adv_action') if 'adv_action' in d
                    else torch.zeros((n, 0), device=dev)),
        adv_valid=torch.tensor(np.asarray(d.get('adv_valid', np.zeros(n, bool)), bool)
                               .reshape(n), device=dev))


def mlp_params_from_numpy(layers, device='cuda'):
    """MLP parameters (``math/networks.py`` layout) from a JAX ``mlp_init``
    pytree given as numpy: a list of ``{'w': (in, out), 'b': (out,)}``."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(layer[k], np.float32), device=dev)
             for k in ('w', 'b')} for layer in layers]


def normalizer_from_numpy(d, device='cuda'):
    """``NormalizerState`` from a JAX ``NormalizerState`` given as a dict of
    numpy arrays (``mean``, ``var``, ``count``); None stays None."""
    if d is None:
        return None
    dev = resolve_device(device)
    return NormalizerState(**{k: torch.tensor(np.asarray(d[k], np.float32), device=dev)
                              for k in ('mean', 'var', 'count')})


def ret_state_from_numpy(d, device='cuda'):
    """``RetState`` from a JAX ``RetState`` given as a dict (``rms``, a
    normalizer dict, and ``ret``); None stays None."""
    if d is None:
        return None
    dev = resolve_device(device)
    return RetState(rms=normalizer_from_numpy(d['rms'], dev),
                    ret=torch.tensor(np.asarray(d['ret'], np.float32), device=dev))


def _find_adam(state):
    """The ``{'count', 'mu', 'nu'}`` dict that is ``state`` or lies inside it
    (an optax chain's nested tuples of named tuples, or of dicts as
    ``checkpoint.plain`` gives them); None if there is none."""
    if isinstance(state, dict) and 'count' in state:
        return state
    if 'count' in getattr(state, '_fields', ()):
        return state._asdict()
    for part in state if isinstance(state, (list, tuple)) else ():
        found = _find_adam(part)
        if found is not None:
            return found
    return None


def adam_state_from_numpy(state, device='cuda'):
    """``math/optim.py``'s Adam state from the port's layout or from the JAX
    package's optax chain state (its ``ScaleByAdamState``: ``count``, and
    ``mu`` and ``nu`` as pytrees, flattened in JAX's leaf order)."""
    dev = resolve_device(device)
    adam = _find_adam(state)
    if adam is None:
        raise ValueError('no Adam state (count, mu, nu) in the optimizer state')
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return {'count': torch.tensor(np.asarray(adam['count'], np.int32), device=dev),
            'mu': [f32(a) for a in tree_leaves(adam['mu'])],
            'nu': [f32(a) for a in tree_leaves(adam['nu'])]}


def adam_state_to_numpy(state):
    """The port's Adam state as numpy (``count``, ``mu`` and ``nu`` lists)."""
    to_np = lambda t: t.detach().cpu().numpy()
    return {'count': to_np(state['count']), 'mu': [to_np(t) for t in state['mu']],
            'nu': [to_np(t) for t in state['nu']]}


def normalizer_to_numpy(state):
    """A ``NormalizerState`` or ``RetState`` as the numpy dicts that
    ``normalizer_from_numpy`` and ``ret_state_from_numpy`` take; None stays
    None."""
    if state is None:
        return None
    if isinstance(state, RetState):
        return {'rms': normalizer_to_numpy(state.rms), 'ret': state.ret.cpu().numpy()}
    return {k: getattr(state, k).cpu().numpy() for k in ('mean', 'var', 'count')}


def env_state_to_numpy(est: EnvState) -> dict:
    """A batched ``EnvState`` as the dict of numpy arrays that
    ``env_state_from_numpy`` takes back."""
    d = {f.name: getattr(est, f.name).cpu().numpy() for f in fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: getattr(est.dyn_params, f.name).cpu().numpy()
                       for f in fields(est.dyn_params)}
    return d


def tree_from_numpy(tree, device='cuda'):
    """A pytree of dicts and lists of numpy arrays as float32 tensors."""
    dev = resolve_device(device)
    return tree_unflatten(tree, [torch.tensor(np.asarray(a, np.float32), device=dev)
                                 for a in tree_leaves(tree)])


def tree_to_numpy(tree):
    """A pytree of dicts and lists of tensors as numpy arrays."""
    return tree_unflatten(tree, [t.detach().cpu().numpy() for t in tree_leaves(tree)])


def replay_from_numpy(d, device='cuda'):
    """A ``ReplayState`` from a dict of numpy arrays (``data``, ``ptr``,
    ``count``): the port's checkpoint layout, or the JAX package's ring as
    ``checkpoint.plain`` gives it."""
    from safe_control_gym_tpu_torch.controllers.off_policy_utils import ReplayState
    dev = resolve_device(device)
    return ReplayState(
        data={k: torch.tensor(np.asarray(v, np.float32), device=dev) for k, v in d['data'].items()},
        ptr=torch.tensor(int(np.asarray(d['ptr'])), dtype=torch.int64, device=dev),
        count=torch.tensor(int(np.asarray(d['count'])), dtype=torch.int64, device=dev))


def replay_to_numpy(state) -> dict:
    """A ``ReplayState`` as the dict of numpy arrays ``replay_from_numpy`` takes."""
    return {'data': {k: v.cpu().numpy() for k, v in state.data.items()},
            'ptr': state.ptr.cpu().numpy(), 'count': state.count.cpu().numpy()}
