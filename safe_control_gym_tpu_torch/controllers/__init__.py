"""Controllers of the port, registered at import time: LQR, iLQR and PID;
MPC, linear MPC, MPC_ACADOS and GP-MPC; and the RL learners, each with
training, evaluation, ``save`` and ``load``: PPO, SAC, DDPG, SafeExplorerPPO,
RARL and RAP (the last two need an env with ``adversary_disturbance``)."""

from safe_control_gym_tpu_torch.utils.registration import register

register(idx='lqr',
         entry_point='safe_control_gym_tpu_torch.controllers.lqr.lqr:LQR',
         config_entry_point='safe_control_gym_tpu_torch.controllers.lqr:lqr.json')
register(idx='ilqr',
         entry_point='safe_control_gym_tpu_torch.controllers.lqr.ilqr:iLQR',
         config_entry_point='safe_control_gym_tpu_torch.controllers.lqr:ilqr.json')
register(idx='pid',
         entry_point='safe_control_gym_tpu_torch.controllers.pid.pid:PID',
         config_entry_point='safe_control_gym_tpu_torch.controllers.pid:pid.json')
register(idx='mpc',
         entry_point='safe_control_gym_tpu_torch.controllers.mpc.mpc:MPC',
         config_entry_point='safe_control_gym_tpu_torch.controllers.mpc:mpc.json')
register(idx='linear_mpc',
         entry_point='safe_control_gym_tpu_torch.controllers.mpc.linear_mpc:LinearMPC',
         config_entry_point='safe_control_gym_tpu_torch.controllers.mpc:linear_mpc.json')
register(idx='gp_mpc',
         entry_point='safe_control_gym_tpu_torch.controllers.mpc.gp_mpc:GPMPC',
         config_entry_point='safe_control_gym_tpu_torch.controllers.mpc:gp_mpc.json')
register(idx='mpc_acados',
         entry_point='safe_control_gym_tpu_torch.controllers.mpc.mpc_acados:MPC_ACADOS',
         config_entry_point='safe_control_gym_tpu_torch.controllers.mpc:mpc_acados.json')
register(idx='ppo',
         entry_point='safe_control_gym_tpu_torch.controllers.ppo.ppo:PPO',
         config_entry_point='safe_control_gym_tpu_torch.controllers.ppo:ppo.json')
register(idx='sac',
         entry_point='safe_control_gym_tpu_torch.controllers.sac.sac:SAC',
         config_entry_point='safe_control_gym_tpu_torch.controllers.sac:sac.json')
register(idx='ddpg',
         entry_point='safe_control_gym_tpu_torch.controllers.ddpg.ddpg:DDPG',
         config_entry_point='safe_control_gym_tpu_torch.controllers.ddpg:ddpg.json')
register(idx='safe_explorer_ppo',
         entry_point='safe_control_gym_tpu_torch.controllers.safe_explorer.safe_ppo:SafeExplorerPPO',
         config_entry_point='safe_control_gym_tpu_torch.controllers.safe_explorer:safe_explorer_ppo.json')
register(idx='rarl',
         entry_point='safe_control_gym_tpu_torch.controllers.rarl.rarl:RARL',
         config_entry_point='safe_control_gym_tpu_torch.controllers.rarl:rarl.json')
register(idx='rap',
         entry_point='safe_control_gym_tpu_torch.controllers.rarl.rap:RAP',
         config_entry_point='safe_control_gym_tpu_torch.controllers.rarl:rap.json')
