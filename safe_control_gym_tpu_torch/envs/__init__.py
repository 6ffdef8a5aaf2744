"""Environments of the port, registered at import time."""

from safe_control_gym_tpu_torch.utils.registration import register

register(idx='cartpole',
         entry_point='safe_control_gym_tpu_torch.envs.cartpole:CartPole',
         config_entry_point='safe_control_gym_tpu_torch.envs:cartpole.json')
register(idx='quadrotor',
         entry_point='safe_control_gym_tpu_torch.envs.quadrotor:Quadrotor',
         config_entry_point='safe_control_gym_tpu_torch.envs:quadrotor.json')
