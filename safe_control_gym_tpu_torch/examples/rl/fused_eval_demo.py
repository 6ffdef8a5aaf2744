"""Fleet-scale evaluation of a trained PPO policy: thousands of envs in one rollout.

Port of ``examples/rl/fused_eval_demo.py``: ``ctrl.evaluate_fused`` runs the
whole closed loop (the actor, the env step, auto-reset, the episode
statistics) as K4's policy mode on the card where its gates admit the
config, the per-step path elsewhere; the committed cartpole model
(``examples/rl/models/ppo/ppo_model_cartpole_stab.pt``) with its training
task. ``run`` returns ``evaluate_fused``'s result:

    python -m safe_control_gym_tpu_torch.examples.rl.fused_eval_demo [batch] [n_steps] \\
        [--device cpu]
"""

import os
import sys
from functools import partial

from safe_control_gym_tpu_torch.examples import demo_argv, example_dir
from safe_control_gym_tpu_torch.utils.registration import get_config, make


def run(batch=1024, n_steps=2048, curr_path=None, device='cuda'):
    curr_path = example_dir('rl') if curr_path is None else curr_path
    # The model's training task (config_overrides/cartpole/cartpole_stab.yaml).
    env_func = partial(
        make, 'cartpole', device=device, seed=42, ctrl_freq=50, pyb_freq=50,
        normalized_rl_action_space=True, task='stabilization',
        task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.005},
        episode_len_sec=5, cost='rl_reward', randomized_init=True, done_on_out_of_bound=True)
    ctrl = make('ppo', env_func, **{**get_config('ppo'), 'training': False})
    ctrl.load(os.path.join(curr_path, 'models', 'ppo', 'ppo_model_cartpole_stab.pt'))
    res = ctrl.evaluate_fused(batch=batch, n_steps=n_steps, seed=0)
    ctrl.close()
    return res


def main(argv=None):
    """``argv`` (default ``sys.argv[1:]``): ``[batch] [n_steps] [--device DEV]``."""
    args, device = demo_argv(sys.argv[1:] if argv is None else argv)
    batch = int(args[0]) if args else 1024
    n_steps = int(args[1]) if len(args) > 1 else 2048
    res = run(batch, n_steps, device=device)
    print(f"path: {res['path']}")
    print(f"evaluated {res['total_steps']:,} closed-loop steps "
          f"({res['episodes']:,} episodes) at {res['steps_per_sec'] / 1e6:.1f}M steps/s")
    print(f"mean episode return {res['ep_return_mean']:.2f}, "
          f"mean length {res['ep_length_mean']:.1f}")
    return res


if __name__ == '__main__':
    main()
