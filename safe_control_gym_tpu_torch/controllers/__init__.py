"""Controllers of the port, registered at import time: LQR, iLQR and PID;
MPC, linear MPC, MPC_ACADOS and GP-MPC; PPO (with training), SAC and DDPG (at
inference; their training and the other controllers come with later
slices)."""

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
