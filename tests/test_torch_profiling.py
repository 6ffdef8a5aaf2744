"""The port's spans and counters (``utils/profiling.py``) on the CPU: with no
profiler running they record nothing and open no ``record_function``; under
a profiler each span's stamped interval lies on the clock of its
``record_function`` event in the same trace; the ring keeps its bound and
counts what it lets go; one PPO iteration emits its spans with their nesting
and counts and trains bit for bit as it does untraced; and
``evaluate_policy_fused``'s kernel path emits its phases."""

import functools
from collections import Counter, deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from safe_control_gym_tpu_torch.experiments.fused_eval import evaluate_policy_fused
from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
from safe_control_gym_tpu_torch.math.optim import tree_leaves
from safe_control_gym_tpu_torch.utils import profiling
from safe_control_gym_tpu_torch.utils.registration import make


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring for the test."""
    monkeypatch.setattr(profiling, 'events', deque(maxlen=profiling.RING_SIZE))
    monkeypatch.setattr(profiling, 'dropped', 0)
    return profiling


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def spans(ring, name):
    return [e for e in ring.events if isinstance(e, profiling.Span) and e.name == name]


def test_off_records_nothing_and_opens_no_range(ring, monkeypatch):
    def no_range(name):
        raise AssertionError('record_function opened with no profiler running')

    monkeypatch.setattr(torch.profiler, 'record_function', no_range)
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiling.annotate('a'), profiling.annotate('b')
    assert first is second
    with first:
        with second:
            profiling.count('host_reads', 3)
    assert len(ring.events) == 0 and ring.dropped == 0


def test_on_spans_share_the_profilers_clock(ring):
    with cpu_profile() as prof:
        # The first range a profiler opens in a process takes about a
        # millisecond to open (its own set-up), which the range counts and
        # a span, stamped once its range is open, does not.
        with torch.profiler.record_function('first'):
            pass
        for i in range(20):
            with profiling.annotate('outer'):
                with profiling.annotate('inner'):
                    torch.ones(64).sum()
        profiling.count('host_reads', 2)
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in ('outer', 'inner'):
            ranges.setdefault(ev.name(), []).append((ev.start_ns(), ev.duration_ns()))
    for name in ('outer', 'inner'):
        mine = spans(ring, name)
        assert len(mine) == len(ranges[name]) == 20
        for s, (start, dur) in zip(sorted(mine, key=lambda s: s.t0_ns), sorted(ranges[name])):
            # Stamped inside the range's opening and after its closing.
            assert 0 <= s.t0_ns - start < 1e6
            assert 0 <= s.t1_ns - (start + dur) < 1e6
    counts = [e for e in ring.events if isinstance(e, profiling.Count)]
    assert counts == [profiling.Count('host_reads', counts[0].t_ns, 2)]
    assert max(s.t1_ns for s in spans(ring, 'outer')) <= counts[0].t_ns


def test_ring_keeps_its_bound_and_counts_what_it_drops(ring, monkeypatch):
    monkeypatch.setattr(profiling, 'events', deque(maxlen=4))
    with cpu_profile():
        for i in range(7):
            with profiling.annotate(f's{i}'):
                pass
        profiling.count('host_reads')
    assert [e.name for e in profiling.events] == ['s4', 's5', 's6', 'host_reads']
    assert profiling.dropped == 4


def _ppo(system, tmp_path):
    env_id, task, algo = eval_config('ppo', system)
    algo = {**algo, 'rollout_batch_size': 8, 'rollout_steps': 5, 'mini_batch_size': 16,
            'opt_epochs': 2, 'log_interval': 0, 'eval_interval': 0, 'save_interval': 0,
            'num_checkpoints': 0, 'tensorboard': False}
    ctrl = make('ppo', functools.partial(make, env_id, device='cpu', **task), training=True,
                output_dir=str(tmp_path), checkpoint_path='', seed=3, **algo)
    ctrl.reset()
    return ctrl


def _inside(inner, outer):
    return [s for s in inner if any(o.t0_ns <= s.t0_ns and s.t1_ns <= o.t1_ns for o in outer)]


@pytest.mark.parametrize('system', ['cartpole', 'quadrotor_3D'])
def test_ppo_iteration_spans_and_bits(ring, tmp_path, system):
    plain = _ppo(system, tmp_path / 'plain')
    want = plain._iterations(1)
    traced = _ppo(system, tmp_path / 'traced')
    with cpu_profile():
        got = traced._iterations(1)
    assert got == want
    for a, b in zip(tree_leaves(traced.agent.params), tree_leaves(plain.agent.params)):
        assert torch.equal(a, b)
    for state in ('actor_opt_state', 'critic_opt_state'):
        for a, b in zip(tree_leaves(getattr(traced.agent, state)),
                        tree_leaves(getattr(plain.agent, state))):
            assert torch.equal(a, b)
    assert torch.equal(traced._obs, plain._obs)

    _, num_mb, _ = traced.agent.minibatch_plan(traced.N * traced.T)
    steps = traced.agent.opt_epochs * num_mb
    names = Counter(e.name for e in ring.events)
    assert names == {'ppo.iteration': 1, 'ppo.rollout': 1, 'env.step_autoreset': traced.T,
                     'ppo.returns': 1, 'ppo.update': 1, 'ppo.update.grad': steps,
                     'ppo.update.optim': steps, 'ppo.read': 1, 'host_reads': 1}
    s = {name: spans(ring, name) for name in names if name != 'host_reads'}
    nesting = [('ppo.rollout', 'ppo.iteration'), ('env.step_autoreset', 'ppo.rollout'),
               ('ppo.returns', 'ppo.rollout'), ('ppo.update', 'ppo.iteration'),
               ('ppo.update.grad', 'ppo.update'), ('ppo.update.optim', 'ppo.update.grad'),
               ('ppo.read', 'ppo.iteration')]
    for inner, outer in nesting:
        assert len(_inside(s[inner], s[outer])) == len(s[inner]), (inner, outer)
    # The returns follow the last step; the update follows the rollout.
    assert max(x.t1_ns for x in s['env.step_autoreset']) <= s['ppo.returns'][0].t0_ns
    assert s['ppo.rollout'][0].t1_ns <= s['ppo.update'][0].t0_ns
    (read,), (reads,) = s['ppo.read'], [e for e in ring.events if e.name == 'host_reads']
    assert read.t0_ns <= reads.t_ns <= read.t1_ns and reads.n == 1


def _fused_eval_spans(ring):
    return sorted((e for e in ring.events
                   if isinstance(e, profiling.Span) and e.name.startswith('fused_eval')),
                  key=lambda e: (e.t0_ns, -e.t1_ns))


def test_fused_eval_kernel_path_phases(ring, tmp_path):
    ctrl = _ppo('cartpole', tmp_path)
    with cpu_profile():
        out = evaluate_policy_fused(ctrl, batch=16, n_steps=20, n_reps=1, use_kernel=True,
                                    return_per_env=True)
    assert out['path'] == 'policy-in-kernel'
    # One call span with its phases nested: the spec's prep, the kernel
    # inputs' prep, the warm-up launch, its per-env read, the timed launch.
    # On the CPU no synchronization runs: the one read is the per-env read.
    call, *phases = _fused_eval_spans(ring)
    assert call.name == 'fused_eval'
    assert [p.name for p in phases] == ['fused_eval.prep', 'fused_eval.prep',
                                        'fused_eval.launch', 'fused_eval.read',
                                        'fused_eval.launch']
    assert all(call.t0_ns <= p.t0_ns and p.t1_ns <= call.t1_ns for p in phases)
    (reads,) = [e for e in ring.events if e.name == 'host_reads']
    assert reads.n == len(out['per_env'])
    (read,) = spans(ring, 'fused_eval.read')
    assert read.t0_ns <= reads.t_ns <= read.t1_ns


def test_fused_eval_per_step_path_has_no_kernel_phases(ring, tmp_path):
    ctrl = _ppo('cartpole', tmp_path)
    with cpu_profile():
        out = evaluate_policy_fused(ctrl, batch=16, n_steps=20, n_reps=1, use_kernel=False)
    assert out['path'] == 'per-step-scan'
    assert [e.name for e in _fused_eval_spans(ring)] == ['fused_eval', 'fused_eval.prep']
    assert not [e for e in ring.events if e.name == 'host_reads']
