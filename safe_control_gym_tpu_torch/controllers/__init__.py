"""Controllers of the port, registered at import time: PPO, SAC and DDPG at
inference (their training and the other controllers come with later slices)."""

from safe_control_gym_tpu_torch.utils.registration import register

register(idx='ppo',
         entry_point='safe_control_gym_tpu_torch.controllers.ppo.ppo:PPO',
         config_entry_point='safe_control_gym_tpu_torch.controllers.ppo:ppo.json')
register(idx='sac',
         entry_point='safe_control_gym_tpu_torch.controllers.sac.sac:SAC',
         config_entry_point='safe_control_gym_tpu_torch.controllers.sac:sac.json')
register(idx='ddpg',
         entry_point='safe_control_gym_tpu_torch.controllers.ddpg.ddpg:DDPG',
         config_entry_point='safe_control_gym_tpu_torch.controllers.ddpg:ddpg.json')
