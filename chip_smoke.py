"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time its
kernels, then drive the batched cartpole and quadrotor rollouts, the
closed-loop evaluation of the committed RL models, PPO training, the
model-based controllers (LQR, iLQR, PID), the MPC family (MPC, linear MPC,
MPC_ACADOS), GP-MPC with its batch and the scenario solve, the safety
filters (linear MPSC, CBF, CBF-NN), SAC and DDPG training, RARL, RAP and
SafeExplorerPPO with the env's adversary channel, the experiment layer
(train_rl_controller, the vectorized envs, HPO with population PPO), the
env's remaining features (the 1D quad, the physics modes, randomized
inertial properties, rendering), the multi-GPU paths over
torch.distributed (on this one card) and the example scripts through the
port's entry points.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase safety    # phases control, mpc, gp_mpc, safety,
                                            # off_policy, robust, experiment,
                                            # env_extras, multigpu, examples
                                            # alone
                                            # (comma-separated), no result
                                            # line

Phases, one JSON line each:
  1. card      the card's name and power limit (nvidia-smi);
  2. build     nvcc of every csrc/*.cu, one process per source, timed;
  3. k1, k2, k3  the per-step physics kernels (cartpole_advance, quad2d_advance,
               quad3d_advance) against their plain versions, bit for bit, on
               every case of benchmark_suite.physics_cases: random inputs
               with tab or world forces at B=4096, a hover (angles exactly
               0), angles past sinf's fast range on every 97th env (the
               step's library recompute), B=4109 (a ragged last warp), four
               warps an SM (B=16896 on 132 SMs) and n_substeps 7 (the
               runtime-count instantiation); each row's time primed and back
               to back, the launch floor (an empty kernel on the same grid),
               B=65536, and ptxas's registers and spills of each
               instantiation; the kernels line adds each row's chain bound
               (20 x one substep's chain from the phase chain) and issue
               floor (20 x one substep's fast-path instructions at one a
               cycle);
  4. k4, k5    the whole-rollout kernels (cartpole_rollout; quad2d_rollout and
               quad3d_rollout) against their plain versions, bit for bit, at
               B=4096 in three modes (replay, tracking with quadratic cost,
               constrained with white action noise and Philox draws), and
               constrained at B=4109, at n_substeps 7 and 4 (the general path),
               at four warps an SM (B=16896 on 132 SMs), on a hover replay
               and with angles past sinf's fast range (the step's library
               recompute);
     chain     csrc/exact_math.cuh against the CUDA math library, the SASS of
               the substep loops, ns a substep on random and hover rows and
               at B=65536, the latencies of the chain's instructions on this
               card (csrc/latency_probe.cu), the chain cycles of a substep at
               those latencies and the SM clock (experiments/chain.py); the
               open-loop rows of the kernels line gain chain_bound_ms,
               issue_floor_ms, lanes_per_env and these times;
  5. main_path make(..., device='cuda') -> measure_batched (per-step path, K1,
               K2, K3) plain and constrained, and measure_rollout_kernel
               (whole-rollout path, K4, K5) on the reference benchmark's rows,
               with every launch counter set to 0 before and read after;
  6. welch     the stochastic K4 and K5 against the per-step path in
               distribution;
  7. k4_policy, k5_policy  K4 and K5 in policy mode (the committed actors:
               deterministic PPO with obs normalization, deterministic SAC
               256 wide with relu and squash, stochastic PPO with Philox
               exploration; a ragged batch, B=4109, whose last tile of envs
               is partly filled; a random 384 -> 1000 actor, whose H2 the
               kernel runs in chunks; then the inputs the closed loop gives the
               kernel for each committed model it admits) against their plain
               versions at B=4096; each case also reports its time a step,
               its shares of the ops bound and of the float32 ceiling
               without fused multiply-adds, one block's time (32 envs), and
               actor_library_ms, the actor alone as three torch.addmm in a
               CUDA graph (a yardstick the port never calls);
  8. closed_loop  the slice's main path: make(algo, ...) -> ctrl.load(the
               committed *_stab model) -> ctrl.evaluate_fused(batch=4096) for
               PPO and SAC on cartpole and the 2D and 3D quads, each row's path
               and launch counts asserted, then measure_closed_loop_kernel on
               bench.py's closed-loop rows and one at the SAC width, with
               every launch counter set to 0 before and read after;
  9. welch_closed_loop  stochastic PPO through the kernel path against the
               per-step path, per env, in distribution;
 10. ppo_train PPO training through make('ppo', ..., training=True): the
               committed cartpole config (64 envs x 150 steps, 300k env
               steps) to its end, then ctrl.run(n_episodes=10), gated on
               finite losses, total_steps, K1's launches (iterations x T plus
               the eval's steps) and an eval return of PPO_EVAL_BAR; the
               committed 2D and 3D configs (128 wide) for
               PPO_QUAD_ITERATIONS each, gated on finite losses and K2's or K3's launches; one
               update on a batch of the card's last cartpole rollout, card
               against CPU on the same permutations (params 1e-4); a
               torch.profiler window over a T_TRACE-step rollout and one
               epoch on its batch (the
               device's busy share); every launch counter set to 0 before
               each training part and read after;
 11. control   model-based control through make('ilqr' | 'lqr' | 'pid',
               partial(make, env, device='cuda', ...)): K1 at 50 substeps and
               K2 at 4 (the control configs' counts) bit for bit against their
               plain versions at B=4096 and B=1, the Riccati solvers and expm
               on the card against scipy, eigh against iLQR's closed-form
               inverse of H; then, every launch counter set to 0 before and
               read after, iLQR's solve_batch at B=4096 on
               examples/lqr/batched_ilqr_demo.py's cartpole (T=45, 50
               substeps) and the committed 2D quad example (its first 2 s,
               T=120, 4 substeps), 10 iterations each, K1's or K2's launches exactly
               10 x T, every card policy's best cost held to a CPU rollout of
               it (rtol 1e-3), the first 64 problems to the port's CPU solve
               of them: on the cartpole all equal (costs, cost curves, gains,
               feedforwards rtol 1e-3, counts and flags exact), on the
               ill-conditioned 2D solve a share CONTROL_AGREE_SHARE in best
               cost and iteration count, beside the CPU's own share under a
               1e-6 change of the initial states; LQR on the cartpole stab example, card against
               CPU (states 1e-4); PID on the 3D tracking example, the card's
               loop recorded, the CPU's PID on its observations and the CPU's
               env stepped from each of its states under its action (1e-4); a
               torch.profiler window over one cartpole solve;
 12. mpc       the gradient case: K1-K3's backward through the kernel
               (``_PlainGrad``) against autograd through the plain twin on
               the same card inputs, and examples/differentiable_sim_demo.py's
               cost gradient (T=8) through the card's env against the CPU's;
               K1 and K2 at the MPC loops' B=1 and substeps bit for bit
               against their plain versions; then, every launch counter set
               to 0 before and read after,
               make('linear_mpc' | 'mpc' | 'mpc_acados', partial(make, env,
               device='cuda', ...)) -> reset() -> run() on the examples'
               configs at horizon 20: linear MPC on linear_mpc_quadrotor_2D_track
               (its first 150 of 300 steps, K2 at 20 substeps), MPC on mpc_cartpole_stab (3 SQP)
               and MPC_ACADOS with RTI (the first 20 of 90 steps each, K1 at 50
               substeps), K1's
               or K2's launches exactly the steps, each step gated against the
               port's CPU controller fed the card's observation and warm start
               (MPC_AGREE_SHARE of the actions within MPC_ATOL; every card
               answer re-evaluated on the CPU: residual under the controller's
               feasibility bound, cost within MPC_COST_RTOL), the card's
               actions replayed through a card env with pallas_physics=False
               (its states equal the loop's, 0.0), one step under
               torch.profiler; select_action_batch at B_MPC on
               examples/mpc/batched_mpc_demo.py's problem (seconds, solves/s,
               converged share, ADMM iterations, peak memory, a torch.profiler
               window), every card answer re-evaluated on the CPU (residual
               under the feasibility bound), its first MPC_GATE_ROWS problems
               against the port's CPU solve (actions, flags, costs);
 13. gp_mpc    K1 at B=1 and 50 substeps and K2 at B=1 and 8 bit for bit
               against their plain versions; then, every launch counter set
               to 0 before and read after, make('gp_mpc', partial(make, env,
               device='cuda', ...)) -> reset() -> learn() -> run():
               gp_mpc_cartpole_stab (horizon 15, 80 samples, 150 Adam steps;
               the first GP_CARTPOLE_STEPS of its 90 steps) and tests/test_gp_mpc.py's 2D
               quad (horizon 10, 60 samples, 120 Adam steps, the first 30 of
               its 60 steps);
               each loop's GPs against the port's CPU GPs trained on the
               card's data, the fused tightening against the host reference
               along the card's plans, each step against the CPU controller
               fed the card's observation, warm start and GP data (phase
               mpc's gate, capped-row counts equal), the replay through a
               pallas_physics=False env, K1's or K2's launches exactly the
               samples and the steps; GP_ONLINE_STEPS cartpole steps with online learning,
               card against CPU; select_action_batch at B_GP (2 passes) on
               examples/mpc/batched_gp_mpc_demo.py's problem (seconds,
               solves/s, peak memory, a torch.profiler window), every answer
               re-evaluated on the CPU, its first 64 rows against the CPU's
               (flags and capped-row counts equal, actions by phase safety's
               _agree, dynamics defects no larger than the CPU's own);
               select_action_scenarios
               with 16 pole lengths on examples/mpc/scenario_mpc_demo.py's
               problem, 10 steps of the multiple-model pick card against CPU;
               a torch.profiler window of two cartpole loop steps;
 14. safety    K1 at B=1 and 1 and 50 substeps and K2 at B=1 and 20 substeps
               bit for bit against their plain versions; then, every launch
               counter set to 0 before and read after, through
               BaseExperiment(...).run_evaluation and make('linear_mpsc' |
               'cbf' | 'cbf_nn', partial(make, env, device='cuda', ...)):
               BASELINE.json's fifth config (SAC on the 2D quad, the committed
               model, uncertified, then certified by linear MPSC loaded from
               the committed P; the 250-step episode uncertified, its first
               CONFIG5_CERTIFIED_STEPS steps certified, K2's launches exactly
               the steps); learn()
               on examples/mpsc/batched_certification_demo.py's cartpole
               (n_samples 120: collection, descent and search timed;
               its P's blocks certified in float64 and its log det against
               the CPU's on the same residuals, computed in a worker process);
               certify_action_batch at B_SAFETY on the demo's states and
               actions (seconds, certifications/s, ADMM iterations, peak
               memory, a torch.profiler window) and an LQR loop certified by
               the learned filter (its first CERT_LQR_STEPS steps); CBF and CBF-NN (the committed model) on
               examples/cbf's cartpole (50 Hz, one substep) with LQR, a loop
               and a batch each; every loop's certifications against the
               port's CPU filter fed the same state, action and warm state,
               and replayed through a pallas_physics=False card env (states
               equal, 0.0); every batch answer re-evaluated on the CPU, its
               first SAFETY_GATE_ROWS against the CPU's batch (see the
               phase's constants); config 5's ms a certification with the
               QP's stages launched and captured, in turns, and a
               torch.profiler window of two of its steps;
 15. off_policy  SAC and DDPG training through make('sac' | 'ddpg', partial(
               make, env, device='cuda', ...), training=True), every launch
               counter set to 0 before each part and read after: SAC on
               sac_cartpole (N=8, train_interval 100, batch 256, hidden 256;
               max_env_steps cut to OFF_POLICY_STEPS, its warm-up of 1000
               kept), then run(n_episodes=10), gated on finite losses,
               total_steps, K1's launches (every collect step and every eval
               step) and an eval return above SAC_EVAL_BAR; a torch.profiler
               window of one collect and one train phase (kernels a step and
               an update, the device's busy share); SAC on the committed 2D
               and 3D configs for OFF_POLICY_QUAD_ITERATIONS iterations past
               the warm-up, gated on K2's and K3's launches; DDPG with
               tests/test_rl_offpolicy.py's settings (not saturated, finite
               returns); one SAC and one DDPG update card against a CPU copy
               on the same batch and normals (every array of the agent within
               OFF_POLICY_UPDATE_ATOL); evaluate_fused at B of the trained SAC
               and DDPG actors (K4's policy mode: path and launches asserted),
               and K4 on their launch inputs against its plain version (1e-4);
 16. robust    RARL and RAP (2 adversaries) on tests/test_rarl_behavior.py's
               cartpole (dynamics adversary, scale 2.0, 50 substeps) for
               ROBUST_STEPS env steps each, gated on finite losses, K1's
               launches, the first ROBUST_REPLAY collect steps replayed
               through a pallas_physics=False card env with the same actions
               and adversary forces (states equal, 0.0) and a nonzero force;
               one RARL rollout on the 2D quad (K2's world force, replayed
               likewise); SafeExplorerPPO: the committed cartpole model
               through BaseExperiment (average length at least
               SE_EVAL_LENGTH, no violation, K1 a step; the file's PPO
               parameters are NaN, in the JAX package too, so its actions
               are NaN and the bar holds vacuously), the committed 2D quad
               model likewise (finite actions and return, K2 a step), then
               the committed pretrain config cut to SE_EPOCHS constraint
               epochs and one PPO iteration (finite losses, K1's launches);
 17. experiment  the examples' entry points, every launch counter set to 0
               before each part and read after: train_rl_controller.train()
               on examples/rl's ppo_cartpole overrides with max_env_steps cut
               to EXP_TRAIN_STEPS (two iterations of 64 x 150), gated on the
               merged config against the committed JSON copies, K1's launches
               (2 x 150), finite losses, model_latest.pt into a fresh
               controller acting identically, and --restore giving the
               config back; make_vec_envs (TorchVecEnv) on the committed stab
               tasks of the three systems at B_VEC x T_VEC random actions,
               held to FuncEnv.step_autoreset on the same generator (0.0),
               one K1/K2/K3 launch a step, VecRecordEpisodeStatistics'
               episodes equal to the done flags, ctrl steps/s; HPO on
               examples/hpo's PPO config cut to two iterations of 16 x 100:
               two sequential trials (trials.csv, K1's launches), then one
               vectorized round of HPO_TRIALS trials x HPO_REPS repetitions
               as one population (K1's launches 2 x 100 + 251 for the whole
               round, the round's seconds and lane-trainings a second); the
               population's update card against a CPU copy (its first epoch
               within POP_UPDATE_ATOL; the whole update within it on every
               lane the CPU repeats to POP_REPEATABLE under a 1e-7 change of
               the batch, at least POP_REPEATABLE_SHARE of them; the accepted
               actor steps equal) and lane POP_LANE against a one-lane population
               fed the same draws, after the first iteration (parameters
               within POP_UPDATE_ATOL, evaluation returns within
               POP_LANE_RTOL);
 18. env_extras  the env's remaining features at B_EXTRAS (4096), every
               case's step_autoreset on the card against the port's CPU on
               its first EXTRAS_CPU_ROWS envs fed the card's reset draws
               (states within EXTRAS_ATOL, reward sums within it relative,
               done counts and step counters equal): the 1D quad over
               T_EXTRAS_1D random actions; the six physics modes of the 2D
               and 3D quads and pyb_gnd of the 1D quad over T_EXTRAS_MODES
               steps of thrusts about hover from near-ground, moving starts,
               K2/K3 one launch a step on 'pyb' and none on the general
               advance, and each mode against 'pyb' over T_EXTRAS_EFFECT
               hover steps (pyb_gnd, pyb_drag and pyb_gnd_drag_dw apart by
               more than 1e-6, drag not in 1D; pyb_dw within EXTRAS_ATOL);
               randomized inertial properties of the cartpole and the 2D and
               3D quads over T_EXTRAS_RAND steps (the envs that were not
               done keep their parameters exactly, the done ones take the
               fresh draw's; the first draws' means and variances against
               the spec's, z <= 6; K1-K3 no launch), each beside the
               shared-parameter case (one launch a step); rendering, a card
               env's host state within EXTRAS_ATOL of a CPU env's after the
               same steps and, where matplotlib is installed, its frame
               equal to the CPU env's in the same state and a gui=True
               env's viewer redrawn at every reset and step; each
               case's ms a step (CUDA events around the card's step alone),
               K1-K3 launches a step and physics route;
 19. multigpu  the sharded paths (parallel/sharding.py) on this one card, a
               witness of correctness, not of scaling: one NCCL rank (world
               size 1) in this process and, started meanwhile through
               parallel/launch.spawn_local, two worlds (MG_GLOO_GROUPS) of two
               gloo ranks sharing cuda:0; each case against the same call on
               one unsharded rank: PPO dp and dp x tp on a (1, 2) mesh on
               ppo_cartpole (64 x 150, 64 wide) for MG_PPO_ITERATIONS of
               MG_PPO_EPOCHS epochs, SAC dp on sac_cartpole (256 wide) to
               MG_SAC_STEPS, one RARL cycle, the linear MPSC certification
               and the NMPC sweep at MG_B, a population of two lanes a rank,
               evaluate_fused(mesh=...) of the committed cartpole PPO at MG_B
               over MG_EVAL_T steps; the gates (parameters, replicas and Adam
               states bit-identical, the tp split, flags, reward sums, done
               counts, K1 launches on each rank equal to the unsharded run's)
               and the reported spreads are listed at MG_WORLD; each case's
               seconds on each rank beside the unsharded rank's;
 20. examples  the entry points of safe_control_gym_tpu_torch/examples (the
               examples/ scripts of the JAX package), one cell each on the card
               through its run() or main(), its launches gated (each K1-K3 loop
               exactly its env steps), its seconds printed, and held to the same
               cell on the port's CPU (the CPU's cells in worker processes
               meanwhile): verbose_api's printed arrays, the lqr, pid (the 3D
               custom waypoints through set_reference), mpc, rl (the committed
               2D SAC model), mpsc (the committed filter) and cbf experiments'
               metrics and actions (1e-4); batched_ilqr_demo at EX_B (the first
               rows' costs 1e-3, flags and iterations equal), batched_mpc_demo
               and batched_gp_mpc_demo at EX_B (the first rows by phase safety's
               _agree, flags and capped counts equal), scenario_mpc_demo on
               1 s episodes (costs 1e-4, the identified length equal), the
               sharded sweep's solvers with the committed RPI set (phase safety
               runs learn() on the card), the certification demo on that warm
               filter at EX_B, then the sweep at EX_B on one NCCL rank in this
               process (the first rows against the CPU's filter and NMPC),
               fused_eval_demo at EX_EVAL (K4 in policy mode, the JAX test's
               bars), differentiable_sim_demo at EX_DIFF (the first cost 1e-4,
               the cost falls; phase mpc holds its gradient), one HPO
               trial (the sampler's parameters equal), train_rl and
               generate_pretrained (one iteration each, into a temporary
               directory) with rl_experiment loading each model back on the card
               and the CPU (1e-4);
 21. kernels   one entry per kernel with its launches, error, times and bound
               (K1-K3 also with train_launches and train_shape, from phase
               ppo_train, control_launches and control_shape, from phase
               control, mpc_launches, mpc_shape and grad_max_abs_err, from
               phase mpc, gp_mpc_launches and gp_mpc_shape, from phase
               gp_mpc, safety_launches and safety_shape, from phase safety,
               off_policy_launches and off_policy_shape, from phase
               off_policy, robust_launches and robust_shape, from phase
               robust, experiment_launches and experiment_shape, from phase
               experiment, env_extras_launches and env_extras_shape,
               from phase env_extras, multigpu_launches and
               multigpu_shape, the two gloo ranks' launches in phase
               multigpu, and examples_launches and examples_shape, from phase
               examples; K4's policy row also with off_policy_launches, the
               trained actors' evaluate_fused launches, and examples_launches,
               fused_eval_demo's).
The last line is {"ok": true, "device": {...}}. Any failure raises before it,
and the exit code is then not 0. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import multiprocessing
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

_T_START = time.perf_counter()   # before torch's import: the command's own clock

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores. Integer operations are counted at the
# float32 rate, which can only make a bound smaller.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

B = 4096
B_RAGGED = B + 13      # the policy mode's last tile of 32 envs partly filled
B_BIG = 65536          # the per-step kernels' large-batch time
CHUNKED_WIDTHS = (384, 1000)   # an actor whose H2 the policy kernel runs in chunks
T_CHUNKED = 30
N_SUB, DT = 20, 1e-3
# K4/K5 against the plain version, at lengths cut for the script's time; the
# cartpole's hover replay runs past its 250-step episode, to the time-limit
# reset (the other cases' episodes end by their bounds).
T_CHECK = {'cartpole': 50, 'quadrotor': 30, 'quadrotor_3D': 30}
T_CHECK_HOVER = {'cartpole': 300}
# The policy mode's cases other than the committed models, likewise.
T_POLICY_CHECK = {'cartpole': 50, 'quadrotor': 30, 'quadrotor_3D': 30}
T_PER_STEP = 256       # the per-step path of the main path
T_ROLLOUT = 131072     # the whole-rollout path of the main path
T_WELCH = 1024
T_CLOSED = 500         # the committed models' closed-loop rows (two episodes)
T_COMMITTED = 260      # the committed models against the plain version: past the
                       # 250-step episode, so every env draws a fresh state
T_WELCH_CLOSED = 1000
PPO_QUAD_ITERATIONS = 1   # training iterations of the 2D and 3D configs
T_TRACE = 50              # the profiled PPO rollout's steps (150, a whole one, before PR 15)
# The cartpole training's eval bar: the solved mark, deterministic eval return
# 200 (PERFORMANCE.md:354-356). The JAX package's PPO, trained on the CPU with
# the same config and seed 0, evaluates to 249.28 over 10 episodes
# (tests/test_torch_ppo_train.py::test_cartpole_solves_as_jax_does), so the
# bar is the solved mark and not 0.8 of JAX's return.
PPO_EVAL_BAR = 200.0
PPO_UPDATE_ATOL = 1e-4
# bench.py's closed-loop rows (hidden 64, stochastic), and one at the SAC width.
CLOSED_BENCH = [('cartpole', 64, 'tanh', 1, 65536), ('quadrotor', 64, 'tanh', 1, 65536),
                ('quadrotor_3D', 64, 'tanh', 1, 65536), ('quadrotor_3D', 256, 'relu', 2, 2048)]
ROOT = os.path.dirname(os.path.abspath(__file__))
# Phase control: iLQR's batched solve at B_CONTROL problems, its first
# CONTROL_GATE_ROWS held to the port's CPU solve of the same problems (costs,
# cost curves, gains and feedforwards to rtol 1e-3, with atol 1e-3 for
# entries near 0, as tests/test_ilqr_fused.py; iteration, convergence and
# abort flags equal); the LQR and PID closed loops card against CPU, 1e-4.
B_CONTROL = 4096
CONTROL_GATE_ROWS = 64
CONTROL_RTOL = 1e-3
CONTROL_ATOL = 1e-4
# The 2D quad's solve (at the example's T=360) is ill-conditioned in
# float32: a 1e-6 change of the initial state moves the best cost or the
# iteration count of about one
# problem in seven of the port's own CPU solve, and so does the last digit of
# the LQR gain. There the gate asks this share of the first 64 problems to
# agree with the CPU's solve, reports the CPU's own share under that 1e-6
# change, and holds every card policy's cost to a CPU rollout of it.
CONTROL_AGREE_SHARE = 0.75
CONTROL_PERTURB = 1e-6
# The 2D quad's iLQR solve runs the example's first 2 s (T=120 at 60 Hz) of
# its 6 s episode (T=360), for the script's time (3 s before PR 15).
ILQR_QUAD_EPISODE_SEC = 2
# examples/lqr/batched_ilqr_demo.py's cartpole problem (T=45, 50 substeps).
ILQR_DEMO_TASK = dict(seed=0, cost='quadratic', task='stabilization',
                      task_info={'stabilization_goal': [0.5, 0.0],
                                 'stabilization_goal_tolerance': 0.0},
                      randomized_init=False, episode_len_sec=3, ctrl_freq=15, pyb_freq=750)

# Phase mpc: K1 and K2 at the MPC loops' shapes (B=1; 50 substeps at dt
# 1/750, 20 at 1/1000) bit for bit against their plain versions, on random
# inputs and on each loop's own: the card loop's actions replayed through a
# card env made with pallas_physics=False give its states exactly. The MPC
# closed loops (B=1) card against the port's CPU controller fed the card's
# observation and warm start at every step: at least MPC_AGREE_SHARE of the
# steps' actions within MPC_ATOL, and every card answer re-evaluated on the
# CPU (its horizon's dynamics defect and constraint violation under the
# controller's own feasibility bound, its cost within MPC_COST_RTOL of the
# CPU answer's). select_action_batch at B_MPC: every card answer
# re-evaluated on the CPU (the residual of each problem flagged feasible
# under its bound), its first MPC_GATE_ROWS problems against the port's CPU
# solve (feasibility flags equal, MPC_AGREE_SHARE of the actions within
# MPC_ATOL, costs within MPC_COST_RTOL). Runs on the H100 read every step and
# row within 4.8e-5 and costs within 1.35e-5 (PERF.md); rounding can pick
# another polish candidate (tests/test_torch_mpc.py: JAX's own action moves
# by up to 2.8e-4 under 1e-7 changes of its input), which these gates
# would report as a failure.
MPC_ATOL = 1e-4
MPC_AGREE_SHARE = 1.0
MPC_COST_RTOL = 1e-4
B_MPC = 4096
MPC_GATE_ROWS = 64
# examples/mpc/batched_mpc_demo.py's problem (horizon 20, 3 SQP iterations).
MPC_DEMO_TASK = dict(seed=0, cost='quadratic', ctrl_freq=15, pyb_freq=750,
                     constraints=[{'constraint_form': 'default_constraint',
                                   'constrained_variable': 'input'}],
                     task_info={'stabilization_goal': [0.0],
                                'stabilization_goal_tolerance': 0.01},
                     randomized_init=False)
MPC_DEMO_ALGO = dict(q_mpc=[1], r_mpc=[0.1], horizon=20, sqp_iters=3)
# The cartpole MPC and MPC_ACADOS loops run the first 20 of their 90-step
# episode, for the script's time.
MPC_CARTPOLE_STEPS = 20
MPC_QUAD_STEPS = 150      # the first 150 of linear_mpc_quadrotor_2D_track's 300 steps
# The gradient case: K1-K3 backward through the kernel against autograd through
# the plain twin on the same card inputs (relative to the gradient's largest
# entry), and examples/differentiable_sim_demo.py's cost over GRAD_T actions,
# card against CPU (GRAD_RTOL, tests/test_torch_grad.py's).
GRAD_KERNEL_RTOL = 1e-6
GRAD_RTOL = 1e-4
GRAD_T = 8
GRAD_DEMO = dict(seed=0, ctrl_freq=15, pyb_freq=750, init_state={'init_theta': 0.4},
                 randomized_init=False, cost='quadratic')

# Phase gp_mpc: K1 at B=1 and 50 substeps and K2 at B=1 and 8 (the GP-MPC
# loops' counts: 15 Hz over 750 Hz, 30 over 240) bit for bit against their
# plain versions. Each loop's GPs, learned on the card, against the port's
# CPU GPs trained on the card's own data: log-parameters within GP_ATOL, and
# the posterior mean and variance at GP_POINTS points within GP_ATOL of
# max(1, |value|). The fused tightening (tensors on the card) against the
# host reference _constraint_tightening along the card's own previous
# plans: within GP_TIGHTEN_RTOL of the largest row, capped-row counts
# equal. Each loop step against the port's CPU controller fed the card's
# observation, warm start and GP data (phase mpc's _mpc_gate: MPC_AGREE_SHARE
# of the actions within MPC_ATOL, every answer re-evaluated on the CPU), and
# the capped-row counts equal; replays through a pallas_physics=False env,
# 0.0; K1's and K2's launches exactly the learn samples and the loop steps.
# The batch (select_action_batch, GP_PASSES passes) at B_GP: every answer
# re-evaluated on the CPU (its initial state and constraints under the
# feasibility bound), its first GP_GATE_ROWS against the CPU's batch: flags
# and capped-row counts equal; actions within MPC_ATOL or, where the CPU's
# own answer moves by more (alone, and to the state changed by
# SAFETY_PERTURB relative, GP_PERTURBED draws), within MPC_ATOL of one of
# those answers (phase safety's _agree); each row's dynamics defect under
# the GP dynamics at most MPC_ATOL over the CPU's own on the same problem
# (the largest of its answers' where it gave several). The batch's cold SQP
# leaves some problems unconverged, their plans' defects up to 1.1 (in the
# JAX package as well), and the CPU's own answers to them spread by 2e-4 to
# 2.6e-3 under such changes: 13 widths of the 2e-4 window that _agree
# accepts about an answer, more than phase safety's 8 draws can cover, so
# GP_PERTURBED is 64. Scenarios likewise, candidate by candidate.
GP_ATOL = 1e-4
GP_POINTS = 64
GP_TIGHTEN_RTOL = 1e-5
GP_CARTPOLE_STEPS = 15          # the first 15 of gp_mpc_cartpole_stab's 90 steps
GP_QUAD_STEPS = 30              # the first 30 of the 2D quad's 60 steps
GP_ONLINE_STEPS = 15
B_GP = 4096
GP_GATE_ROWS = 64
GP_PASSES = 2
GP_PERTURBED = 64
# tests/test_gp_mpc.py's 2D quad (30 Hz over 8 substeps, 60 steps, mass prior
# 0.035, horizon 10, 60 samples, 120 Adam steps).
GP_QUAD_TASK = dict(seed=42, cost='quadratic', quad_type=2, ctrl_freq=30, pyb_freq=240,
                    episode_len_sec=2, randomized_init=False,
                    init_state={'init_x': 0.3, 'init_x_dot': 0, 'init_z': 1.0, 'init_z_dot': 0,
                                'init_theta': 0, 'init_theta_dot': 0},
                    task='stabilization',
                    task_info={'stabilization_goal': [0, 1],
                               'stabilization_goal_tolerance': 0.005},
                    done_on_out_of_bound=False,
                    constraints=[{'constraint_form': 'default_constraint',
                                  'constrained_variable': 'input'}])
GP_QUAD_ALGO = dict(q_mpc=[5, 0.1, 5, 0.1, 0.1, 0.1], r_mpc=[0.1, 0.1], horizon=10,
                    prior_info={'prior_prop': {'M': 0.035}}, train_iterations=1,
                    num_samples=60, optimization_iterations=120, sparse_gp=False, seed=0)
# examples/mpc/batched_gp_mpc_demo.py's problem (horizon 15, numpy seed 0).
GP_DEMO_TASK = dict(seed=0, cost='quadratic', ctrl_freq=15, pyb_freq=750,
                    constraints=[{'constraint_form': 'default_constraint',
                                  'constrained_variable': 'input'},
                                 {'constraint_form': 'default_constraint',
                                  'constrained_variable': 'state'}],
                    task_info={'stabilization_goal': [0.0],
                               'stabilization_goal_tolerance': 0.01},
                    randomized_init=False)
GP_DEMO_ALGO = dict(q_mpc=[1], r_mpc=[0.1], horizon=15,
                    prior_info={'prior_prop': {'pole_length': 1.0}}, num_samples=60,
                    optimization_iterations=120, seed=0)
# examples/mpc/scenario_mpc_demo.py: 16 pole lengths (numpy seed 0, the
# nominal 0.5 first) against a true 0.9, the multiple-model pick for
# SCENARIO_STEPS steps.
N_SCENARIOS = 16
SCENARIO_STEPS = 10
SCENARIO_TASK = dict(seed=42, cost='quadratic', ctrl_freq=15, pyb_freq=750, episode_len_sec=6,
                     randomized_init=False, init_state={'init_theta': 0.15},
                     task_info={'stabilization_goal': [0.0],
                                'stabilization_goal_tolerance': 0.0},
                     inertial_prop={'pole_length': 0.9}, done_on_out_of_bound=False,
                     constraints=[{'constraint_form': 'default_constraint',
                                   'constrained_variable': 'input'}])
SCENARIO_MPC = dict(q_mpc=[5, 0.1, 5, 0.1], r_mpc=[0.1], horizon=15, warmstart=True,
                    sqp_iters=2, use_lqr_gain_and_terminal_cost=True,
                    prior_info={'prior_prop': {'pole_length': 0.5}})

# Phase safety: every certification of the card's closed loops held to the
# port's CPU filter fed the card's state, the same uncertified action and
# the same warm state (the last plan, the QP's warm start and kinf): the
# feasibility and success flags equal, at least SAFETY_AGREE_SHARE of the
# actions within SAFETY_ATOL (as MPC_AGREE_SHARE in phase mpc), and every
# answer the card flags feasible re-evaluated on the CPU (the tube
# problem's constraint violation under the filter's own feasibility bound
# and the true ellipse; CBF: the input rows within feas_tol and the barrier
# row within slack_tolerance + feas_tol |b| (the QP's residual is in
# Ruiz-equilibrated units, whose row scale is at most 1/|b|)). The CPU side
# solves all recorded steps of a loop as one batch (ops/qp.py stops each
# problem at its own stage, so a row's answer is the single solve's up to
# rounding) and then runs certify_action's host logic step by step.
# certify_action_batch at B_SAFETY: every card answer re-evaluated likewise,
# its first SAFETY_GATE_ROWS against the port's CPU batch: flags equal, and
# each action within SAFETY_ATOL of the CPU's or, where the CPU's own answer
# moves by more than SAFETY_ATOL (alone, and to the state changed by
# SAFETY_PERTURB relative, SAFETY_PERTURBED draws, numpy seed 1), within
# SAFETY_ATOL of one of those answers (tests/test_torch_safety_filters.py's
# rule). A batch row that stops at the ADMM budget is fixed only to the
# rounding of its iterations, and the CPU's answers to it in a batch and
# alone can differ by more than SAFETY_ATOL.
SAFETY_ATOL = 1e-4
SAFETY_AGREE_SHARE = 1.0
SAFETY_PERTURB = 1e-7
SAFETY_PERTURBED = 8
B_SAFETY = 4096
SAFETY_GATE_ROWS = 64
# examples/mpsc/batched_certification_demo.py's cartpole and filter (the
# constrained cartpole and MPSC of tests/test_safety_filters.py, 15 Hz over
# 50 substeps, n_samples 120): learn() on the card, its batch and an LQR
# loop certified by the learned filter.
CERT_DEMO_TASK = dict(seed=42, cost='quadratic', ctrl_freq=15, pyb_freq=750,
                      task='stabilization',
                      task_info={'stabilization_goal': [0.0],
                                 'stabilization_goal_tolerance': 0.005},
                      init_state={'init_theta': 0.1}, randomized_init=False,
                      episode_len_sec=6,
                      constraints=[{'constraint_form': 'default_constraint',
                                    'constrained_variable': 'state',
                                    'upper_bounds': [1.5, 2, 0.3, 2],
                                    'lower_bounds': [-1.5, -2, -0.3, -2]},
                                   {'constraint_form': 'default_constraint',
                                    'constrained_variable': 'input',
                                    'upper_bounds': [5], 'lower_bounds': [-5]}],
                      done_on_out_of_bound=False)
CERT_DEMO_SF = dict(horizon=10, q_lin=[1], r_lin=[1], integration_algo='rk4', n_samples=120,
                    tau=0.95, seed=0, use_terminal_set=False)
# learn()'s RPI set: the card's P certifies every sampled S-procedure block
# (largest eigenvalue, float64, in the preconditioned coordinates the
# certification uses, at most RPI_EIG_TOL), and its log det is the CPU's on
# the same residuals within RPI_LOGDET_RTOL, or within the CPU's own spread
# (the largest difference of its answers under two RPI_PERTURB relative
# changes of the residuals) of one of the CPU's answers: the float32 descent
# drifts chaotically along the constraint's edge, and the certification's
# scale search moves log det in steps of nx ln 0.75
# (tests/test_torch_safety_filters.py: JAX's own log det moves by up to 4%
# under such changes).
RPI_EIG_TOL = 1e-6
RPI_LOGDET_RTOL = 1e-3
RPI_PERTURB = 1e-7
# Phase off_policy: SAC on sac_cartpole (N=8, train_interval 100, batch 256,
# hidden 256) cut from 100000 env steps to OFF_POLICY_STEPS with its warm-up
# of 1000; its eval bar is tests/test_rl_offpolicy.py:38's (random actions
# return about 20). SAC on the committed 2D and 3D configs for
# OFF_POLICY_QUAD_ITERATIONS iterations past the warm-up; DDPG with
# tests/test_rl_offpolicy.py:52-63's settings (max_env_steps cut from 4000
# to 2000); one update of each at full
# width card against CPU (OFF_POLICY_UPDATE_ATOL); the trained actors through
# evaluate_fused at B (T_OFF_POLICY_EVAL steps) and K4's policy mode against
# its plain version over T_OFF_POLICY_CHECK steps (1e-4, as phase k4_policy).
OFF_POLICY_STEPS = 4000
SAC_EVAL_BAR = 25.0
OFF_POLICY_QUAD_ITERATIONS = 1
DDPG_TEST = dict(max_env_steps=2000, warm_up_steps=1000, rollout_batch_size=8,
                 train_interval=200, train_batch_size=64, max_buffer_size=20000,
                 actor_lr=0.0003)
OFF_POLICY_UPDATE_ATOL = 1e-4
T_OFF_POLICY_EVAL = 300
T_OFF_POLICY_CHECK = 40
# Phase robust: tests/test_rarl_behavior.py's cartpole (dynamics adversary,
# scale 2.0, 50 substeps) and its RARL settings at the default width (hidden
# 64), ROBUST_STEPS env steps for RARL and for RAP (2 adversaries); the first
# ROBUST_REPLAY collect steps replayed through a pallas_physics=False card env
# (states equal, 0.0); one RARL rollout of ROBUST_QUAD_T steps on the 2D quad
# (K2's force operand). SafeExplorerPPO: the committed cartpole model through
# BaseExperiment at tests/test_safe_explorer_behavior.py:101-102's bar (its
# PPO parameters are NaN, so the bar holds with NaN actions, as in JAX) and
# the committed 2D quad model (finite actions), then
# the committed pretrain config cut to SE_EPOCHS constraint epochs and one
# PPO iteration.
RARL_TASK = dict(seed=3, cost='rl_reward', normalized_rl_action_space=True, randomized_init=True,
                 episode_len_sec=3, ctrl_freq=15, pyb_freq=750,
                 adversary_disturbance='dynamics', adversary_disturbance_scale=2.0)
RARL_ALGO = dict(rollout_batch_size=8, rollout_steps=64, agent_iterations=2,
                 adversary_iterations=2, opt_epochs=5, mini_batch_size=256)
ROBUST_STEPS = 8 * 64 * 4
ROBUST_REPLAY = 64
ROBUST_QUAD_T = 8
SE_EVAL_LENGTH = 240
SE_EPOCHS = 2

# Phase experiment: the examples' entry points. train() on ppo_cartpole cut
# to two iterations of 64 x 150; make_vec_envs at B_VEC over T_VEC random
# actions; HPO on examples/hpo's PPO config cut to two iterations of 16 x
# 100: two sequential trials, then one vectorized round of HPO_TRIALS trials
# x HPO_REPS repetitions.
EXP_RL_OVERRIDES = ['examples/rl/config_overrides/cartpole/cartpole_stab.yaml',
                    'examples/rl/config_overrides/cartpole/ppo_cartpole.yaml']
EXP_TRAIN_STEPS = 19200
B_VEC = 4096
T_VEC = 200
EXP_HPO_OVERRIDES = ['examples/hpo/config_overrides/ppo_cartpole_hpo.yaml']
EXP_HPO_STEPS = 3200
HPO_TRIALS, HPO_REPS, HPO_N_EVAL = 8, 2, 5
# The vectorized round searches the per-lane hyperparameters only, so that
# its trials form one population.
HPO_VECTOR_SPACE = ['actor_lr', 'critic_lr', 'entropy_coef', 'gamma', 'gae_lambda',
                    'clip_param', 'target_kl']
# The population's update, card against CPU: its first epoch within
# POP_UPDATE_ATOL on every lane; the whole update (10 epochs of 25 Adam
# steps) within POP_UPDATE_ATOL on every lane the CPU repeats to within
# POP_REPEATABLE under a 1e-7 change of the batch, at least POP_REPEATABLE_SHARE
# of the lanes; the accepted actor steps equal on every lane. Adam's
# normalized steps amplify rounding where a lane's gradients are near zero:
# the CPU's own whole update then moves by up to 5e-3 under such a change,
# so such a lane has no 1e-4 answer to hold the card to.
POP_UPDATE_ATOL = 1e-4
POP_REPEATABLE = 1e-5
POP_REPEATABLE_SHARE = 0.5
POP_LANE = 3
# Lane 3 of the population against a one-lane population fed the same
# draws, after the first iteration: the same float32 math, but cuBLAS may
# pick another algorithm for a batch of 1 matrix than for 16, so the
# products can round apart; the parameters are held to POP_UPDATE_ATOL (lane
# 3's update is one the CPU repeats to 1e-5), the returns of their
# evaluation to POP_LANE_RTOL of their size.
POP_LANE_RTOL = 1e-3

# Phase env_extras: the env's remaining features at B_EXTRAS, card against
# the port's CPU. The CPU repeats the first EXTRAS_CPU_ROWS envs of each
# batch (the envs of a batch are independent), fed the card's reset draws.
B_EXTRAS = 4096
EXTRAS_CPU_ROWS = 256
EXTRAS_ATOL = 1e-4
# The 3D quad's cases are cut from 100 and 256 steps to keep the phase near
# 40 s: the general advance takes 27-53 ms a step in 3D at B=4096,
# host-bound (PERF.md §4).
T_EXTRAS_1D = 256           # the 1D quad, random actions, auto-reset
# The physics modes from near-ground, moving starts, by quad type.
T_EXTRAS_MODES = {1: 100, 2: 100, 3: 25}
# Randomized inertial properties and the shared case beside, by system.
T_EXTRAS_RAND = {'cartpole': 256, 'quadrotor': 256, 'quadrotor_3D': 64}
T_EXTRAS_EFFECT = 10        # hover steps of each mode against 'pyb'
EXTRAS_MODES = ('pyb', 'dyn', 'pyb_gnd', 'pyb_drag', 'pyb_dw', 'pyb_gnd_drag_dw')
EXTRAS_QUAD = {1: ('quadrotor', dict(quad_type=1, task_info={'stabilization_goal': [0, 1]})),
               2: ('quadrotor', dict(quad_type=2, task_info={'stabilization_goal': [0, 1]})),
               3: ('quadrotor', dict(quad_type=3, task_info={'stabilization_goal': [0, 0, 1]}))}
EXTRAS_BASE = dict(seed=0, ctrl_freq=50, pyb_freq=1000, episode_len_sec=2)
NU_QUAD = {1: 1, 2: 2, 3: 4}

# Phase multigpu: the sharded paths (parallel/sharding.py) on this one card,
# with one NCCL rank (the real communicator, world size 1) and with two gloo
# ranks that share cuda:0; every case against the same call on one
# unsharded rank. A witness of correctness: one card cannot show scaling.
# PPO on ppo_cartpole (64 envs x 150 steps, 64 wide) for MG_PPO_ITERATIONS
# of MG_PPO_EPOCHS epochs (10 in the config), data parallel and dp x tp on
# a (1, 2) mesh; SAC on sac_cartpole (256 wide) through its warm-up and one
# training iteration (100 updates); one RARL cycle of the robust phase's
# config; the certification batch of the constrained cartpole (phase
# safety's system, the committed P) and the NMPC sweep of
# batched_mpc_demo.py at MG_B; a population of the lanes [a, b] a rank at
# phase experiment's widths, one iteration of MG_PPO_EPOCHS epochs;
# evaluate_fused of the committed cartpole PPO at MG_B over MG_EVAL_T
# steps. The learners' parameters are
# held to MG_PARAMS_ATOL (tests/test_multichip_training.py's bar), the eval's
# per-env reward sums to MG_EVAL_ATOL with every done count equal, the
# population's lanes to MG_POP_ATOL; replicas and Adam states bit-identical
# on the ranks. The solvers: every flag equal to the whole batch's on one
# rank, and each rank's actions within MG_SOLVER_ATOL
# (tests/test_sharded_solvers.py's bar) of one unsharded rank's solve of
# the same rows. The card's batched ADMM answer depends on the batch's size
# on a few rows (cuBLAS and the batched factorizations pick their
# algorithms by shape), and one rank's whole batch moves by more than
# MG_SOLVER_ATOL on some rows under a MG_PERTURB change of its input, so
# the sharded actions' distance to the whole batch's is reported beside
# that spread, not gated. The gloo ranks run as MG_GLOO_GROUPS, two
# worlds of two ranks at once.
MG_WORLD = 2
MG_PPO_ITERATIONS = 1
MG_PPO_EPOCHS = 2
MG_SAC_STEPS = 1152     # the warm-up's 1000 steps (11 collects of 12 x 8) and one more
MG_RARL_STEPS = 2048    # one cycle: 2 + 2 iterations of 8 x 64
MG_B = 4096
MG_EVAL_T = 250
MG_POP = dict(rollout_batch_size=16, rollout_steps=100, iterations=1,
              opt_epochs=MG_PPO_EPOCHS, mini_batch_size=64, hidden_dim=64, n_eval=5)
MG_POP_SEEDS = [100, 101]
MG_PARAMS_ATOL = 5e-5
MG_SOLVER_ATOL = 1e-3
MG_EVAL_ATOL = 1e-5
MG_POP_ATOL = 1e-5
MG_PERTURB = 1e-7
MG_TIMEOUT_S = 120
# The certification's first batch in a process takes about 15 s (the first
# captured ADMM stages and the solvers' set-up), so it shares its world
# with the short cases.
MG_GLOO_GROUPS = (['ppo', 'ppo_tp', 'rarl', 'population', 'sac'], ['certify', 'nmpc', 'eval'])

# Operations per env and physics substep (sin and cos count one each):
# cartpole: sin, cos, the reciprocal and 28 multiplies, adds and subtracts;
# 2D quad: one sin/cos pair and 16 others; 3D quad: three sin/cos pairs,
# three divides and 60 others. Per env and call, the hoisted invariants.
OPS_SUBSTEP = {'cartpole': 31, 'quadrotor': 18, 'quadrotor_3D': 69}
OPS_INVARIANT = {'cartpole': 10, 'quadrotor': 10, 'quadrotor_3D': 25}
# Philox4x32-10 (10 rounds of 2 mul-hi/lo pairs, 4 xors and 2 key adds) per
# four words, and the four uniform conversions.
OPS_PHILOX = 10 * 10
OPS_UNIFORM4 = 3 * 4
# K4's other work per env and control step.
OPS_STEP_REST = {'uniform': OPS_UNIFORM4, 'box_muller': 8, 'action': 6, 'reward': 20,
                 'done': 12, 'violation': 12, 'reset': 12}

SYSTEMS = ('cartpole', 'quadrotor', 'quadrotor_3D')
# The committed models' system names, and the benchmark system of each.
MODEL_SYSTEM = {'cartpole': 'cartpole', 'quadrotor_2D': 'quadrotor',
                'quadrotor_3D': 'quadrotor_3D'}
MODELS = [(algo, system) for algo in ('ppo', 'sac') for system in MODEL_SYSTEM]
NX = {'cartpole': 4, 'quadrotor': 6, 'quadrotor_3D': 12}
NU = {'cartpole': 1, 'quadrotor': 2, 'quadrotor_3D': 4}
N_OOB = {'quadrotor': 3, 'quadrotor_3D': 6}
ANGLE_DIM = {'cartpole': 2, 'quadrotor': 4, 'quadrotor_3D': 7}
QUAD_TYPE = {'quadrotor': 2, 'quadrotor_3D': 3}

SRC = 'safe_control_gym_tpu_torch/csrc/'
PHYSICS = {  # per-step physics kernel of each system
    'cartpole': dict(id='K1', name='cartpole_advance', source=SRC + 'cartpole_kernels.cu',
                     replaces='safe_control_gym_tpu/ops/pallas_kernels.py:86'),
    'quadrotor': dict(id='K2', name='quad2d_advance', source=SRC + 'quad_kernels.cu',
                      replaces='safe_control_gym_tpu/ops/pallas_kernels.py:190'),
    'quadrotor_3D': dict(id='K3', name='quad3d_advance', source=SRC + 'quad_kernels.cu',
                         replaces='safe_control_gym_tpu/ops/pallas_kernels.py:322'),
}
ROLLOUT = {  # whole-rollout kernel of each system
    'cartpole': dict(id='K4', name='cartpole_rollout', source=SRC + 'cartpole_kernels.cu',
                     replaces='safe_control_gym_tpu/ops/rollout_kernels.py:427'),
    'quadrotor': dict(id='K5', name='quad2d_rollout', source=SRC + 'quad_kernels.cu',
                      replaces='safe_control_gym_tpu/ops/rollout_kernels.py:850'),
    'quadrotor_3D': dict(id='K5', name='quad3d_rollout', source=SRC + 'quad_kernels.cu',
                         replaces='safe_control_gym_tpu/ops/rollout_kernels.py:850'),
}


def emit(phase, **fields):
    # t_s: seconds since the script started (before torch's import).
    print(json.dumps({'phase': phase, **fields,
                      't_s': round(time.perf_counter() - _T_START, 3)}), flush=True)


def card():
    line = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def time_ms(fn, reps, primed=True):
    """Time of one call of ``fn``: CUDA events around ``reps`` calls after one
    warm-up call. ``primed`` first queues a ~25 ms sleep on the card, so the
    host enqueues the calls while the card is busy and the events measure
    device time only; unprimed, the time also holds the host's launch gaps."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if primed:
        torch.cuda._sleep(50_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _registers(lib, kernel):
    """{instantiation: ptxas's registers, stack and spills} of ``kernel``'s
    instantiations in ``lib`` (from its build's ptxas report)."""
    from safe_control_gym_tpu_torch.experiments import chain, sass
    from safe_control_gym_tpu_torch.ops import _build
    with open(_build.ptxas_log(lib)) as f:
        usage = sass.ptxas_resources(f.read())
    return {f'{kernel}<{",".join(map(str, chain.template_args(fname)))}>': row
            for fname, row in usage.items() if f'{kernel}I' in fname or f'{kernel}E' in fname}


def check_physics(system, dev):
    """K1, K2 or K3 against its plain version on every per-step case, bit for
    bit (the plain version repeats the kernel's float ops, and the exact
    substeps give the library's results), timed on the random case."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.experiments import chain
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    meta = PHYSICS[system]
    kernel, plain = getattr(pk, meta['name']), getattr(pk, meta['name'] + '_plain')
    cases = {}
    for case, args in bs.physics_cases(system, dev, B, N_SUB, DT):
        err = float((kernel(*args) - plain(*args)).abs().max())
        torch.cuda.synchronize()
        cases[case] = dict(B=args[0].shape[0], n_substeps=args[-2], max_abs_err=err)
        emit(meta['id'].lower(), kernel=meta['name'], case=case, tol=0.0, **cases[case])
        if err != 0.0:
            raise RuntimeError(f'{meta["id"]} disagrees with its plain version on {case}: '
                               f'max abs err {err} (must be 0.0)')
    args = (*bs.physics_args(system, dev, B), N_SUB, DT)
    ms = time_ms(lambda: kernel(*args), 200)
    # The plain version's hundreds of launches a call are its cost: timed unprimed.
    plain_ms = time_ms(lambda: plain(*args), 5, primed=False)
    back_to_back_ms = time_ms(lambda: kernel(*args), 200, primed=False)
    launch_floor_ms = time_ms(chain.launch_floor(B, dev), 200)
    big = (*bs.physics_args(system, dev, B_BIG), N_SUB, DT)
    big_batch_ms = time_ms(lambda: kernel(*big), 200)
    del big
    n_bytes = sum(a.numel() * 4 for a in args[:-2]) + B * NX[system] * 4
    b_ms, b_by = bound_ms(n_bytes, B * (N_SUB * OPS_SUBSTEP[system] + OPS_INVARIANT[system]))
    lib = os.path.basename(meta['source'])[:-3]
    row = dict(name=meta['name'], route='cuda', source=meta['source'],
               replaces=meta['replaces'], max_abs_err=max(c['max_abs_err'] for c in
                                                          cases.values()),
               ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None,
               library_note='no single PyTorch call computes n_substeps of this update',
               back_to_back_ms=back_to_back_ms, launch_floor_ms=launch_floor_ms,
               big_batch_ms=big_batch_ms, big_batch_shape=f'B={B_BIG} n_substeps={N_SUB}',
               registers=_registers(lib, meta['name'] + '_kernel'), cases=cases,
               shape=f'B={B} n_substeps={N_SUB}', id=meta['id'])
    emit(meta['id'].lower(), **{k: v for k, v in row.items() if k != 'cases'})
    return row


def _plain_rollout(system):
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    if system == 'cartpole':
        return rk.cartpole_rollout_plain
    return functools.partial(rk.quad_rollout_plain, QUAD_TYPE[system])


def _rollout_cases(system, dev, T, T_hover=None):
    """(name, T, state0, cfg, kwargs) of the checked open-loop cases of
    ``system``: three modes at B (replay, tracking with quadratic cost,
    constrained with noise and Philox draws); constrained draws at B_RAGGED
    (a last warp of 8 envs and a last block partly filled), at n_substeps 7
    and 4 (the kernels' general path; the others run the 20 compiled in) and,
    at a batch of four warps an SM (blocks of 128 threads); a hover replay
    (the angles exactly 0: zero numerators in 3D's quotients) of ``T_hover``
    steps (``T`` if None); and envs started at an angle past sinf's fast
    range (the step recomputed with the library's functions)."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    from safe_control_gym_tpu_torch.utils.registration import make
    g = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for name, constrained, tracking, over in [
            ('replay_stabilization_rl_reward', False, False, {}),
            ('tracking_quadratic', False, True, dict(cost='quadratic')),
            ('constrained_noise_draws', True, False, {})]:
        env = make(system.replace('_3D', ''), device=dev,
                   **bs._env_kwargs(system, constrained, tracking), **over)
        cfg = bs._kernel_cfg(system, env, constrained)
        states, _ = env.func.reset_batch(g, B)
        mode = dict(constrained=constrained)
        if name.startswith('replay'):
            lo = torch.as_tensor(env.action_space.low, device=dev)
            hi = torch.as_tensor(env.action_space.high, device=dev)
            actions = lo + (hi - lo) * torch.rand((T, B, NU[system]), generator=g, device=dev)
            mode = dict(actions=actions[..., 0] if system == 'cartpole' else actions,
                        draw_actions=False)
        kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                  randomized_reset=env.RANDOMIZED_INIT, **mode,
                  **rk.rollout_task_kwargs(env))
        cases.append((name, T, states.state.contiguous(), cfg, kw))
    s0, cfg, kw = cases[-1][2:]
    reset = lambda n: env.func.reset_batch(g, n)[0].state.contiguous()
    cases.append(('ragged_batch_constrained', T, reset(B_RAGGED), cfg, kw))
    for n_sub in (7, 4):
        cases.append((f'substeps_{n_sub}_constrained', T, s0, cfg,
                      dict(kw, n_substeps=n_sub, dt=env.CTRL_TIMESTEP / n_sub)))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cases.append(('large_batch_constrained', T, reset(32 * 4 * n_sm), cfg, kw))
    T_hover = T_hover or T
    hover, raw, cfg_h, kw_h = bs.hover_case(system, dev)
    cases.append(('hover', T_hover, hover.expand(B, -1).contiguous(), cfg_h,
                  dict(kw_h, actions=bs.hover_actions(system, raw, T_hover, B))))
    special = s0.clone()
    special[::97, ANGLE_DIM[system]] = 2.0e5
    cases.append(('angle_past_sinf_fast_range', T, special, cfg, kw))
    return cases


def rollout_ops(system, kw, T, done_total=0.0, batch=B):
    """Operations of a ``batch``-env, T-step rollout in mode ``kw``;
    ``done_total`` is the run's summed done count (fresh states are drawn only
    where done)."""
    if system == 'cartpole':
        ops = N_SUB * OPS_SUBSTEP[system] + OPS_STEP_REST['action'] \
            + OPS_STEP_REST['reward'] + OPS_STEP_REST['done'] + OPS_STEP_REST['reset']
        if kw.get('draw_actions', True) or kw.get('constrained'):
            ops += OPS_PHILOX + OPS_STEP_REST['uniform']
        if kw.get('randomized_reset'):
            ops += OPS_PHILOX + OPS_STEP_REST['uniform']
        if kw.get('constrained'):
            ops += OPS_STEP_REST['box_muller'] + OPS_STEP_REST['violation']
        return batch * T * ops
    nx, nu = NX[system], NU[system]
    ops = N_SUB * OPS_SUBSTEP[system] + OPS_INVARIANT[system]
    ops += nu * (4 + 9)                  # denormalize, clip; motor model
    ops += 6 if nx == 6 else 19          # rotor forces (and yaw torque)
    ops += nx * 6 + nu * 4 + 2           # reward
    ops += N_OOB[system] * 4 + 4         # done
    ops += 3                             # accumulators
    if kw.get('draw_actions', True):
        ops += OPS_PHILOX + OPS_UNIFORM4 + 2 * nu
    if kw.get('constrained'):
        ops += OPS_PHILOX + OPS_UNIFORM4 + nu // 2 * 13 + (nx + nu) * 4
    n = batch * T * ops
    reset_words = (nx + 3) // 4 * (OPS_PHILOX + OPS_UNIFORM4) if kw.get('randomized_reset') else 0
    return n + done_total * (reset_words + 2 * nx)


def rollout_bytes(system, kw, T, batch=B):
    nx = NX[system]
    n = batch * (nx * 4 + nx * 4 + 4 * 4) + (40 if system == 'cartpole' else 105) * 4
    if not kw.get('draw_actions', True):
        n += T * batch * NU[system] * 4
    if 'x_goal' in kw:
        n += kw['x_goal'].numel() * 4
    return n


def check_rollout(system, dev, length=None):
    """K4 or K5 against its plain version on every case of ``_rollout_cases``,
    bit for bit (state and reward sums equal, no count differing), timed on
    the constrained case. ``length`` overrides T."""
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import _kernel
    meta = ROLLOUT[system]
    kernel, plain = _kernel(system)[1], _plain_rollout(system)
    worst = 0.0
    row = None
    for name, T, s0, cfg, kw in _rollout_cases(system, dev, length or T_CHECK[system],
                                               length or T_CHECK_HOVER.get(system)):
        k = kernel(s0, cfg, 7, T, **kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p = plain(s0, cfg, 7, T, **kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        state_err = float((k['state'] - p['state']).abs().max())
        rew_err = float((k['reward_sum'] - p['reward_sum']).abs().max())
        flips = {key: int((k[key] != p[key]).sum())
                 for key in ('done_count', 'ctrl_step', 'violation_count')}
        ok = state_err == 0.0 and rew_err == 0.0 and not any(flips.values())
        emit(meta['id'].lower(), kernel=meta['name'], case=name, T=T, B=s0.shape[0],
             n_substeps=kw['n_substeps'], state_err=state_err, reward_err=rew_err,
             envs_with_other_counts=flips, ok=ok,
             mean_done_count=float(k['done_count'].mean()),
             mean_violation_count=float(k['violation_count'].mean()))
        if not ok:
            raise RuntimeError(
                f'{meta["name"]} disagrees with its plain version on {name}: state err '
                f'{state_err}, reward err {rew_err} (both must be 0.0), envs whose counts '
                f'differ {flips} (must be none: both draw the same Philox numbers and '
                'round the same float ops)')
        worst = max(worst, state_err, rew_err)
        if name == 'constrained_noise_draws':
            ms = time_ms(lambda: kernel(s0, cfg, 8, T, **kw), 5)
            block_s0 = s0[:32].contiguous()
            one_block_ms = time_ms(lambda: kernel(block_s0, cfg, 8, T, **kw), 5)
            done_total = float(kernel(s0, cfg, 8, T, **kw)['done_count'].sum())
            b_ms, b_by = bound_ms(rollout_bytes(system, kw, T),
                                  rollout_ops(system, kw, T, done_total))
            row = dict(name=meta['name'], route='cuda', source=meta['source'],
                       replaces=meta['replaces'], ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       library_note='no single PyTorch call computes a T-step env rollout',
                       one_block_ms=one_block_ms,
                       shape=f'B={B} T={T} constrained, noise and Philox draws',
                       id=meta['id'])
    row['max_abs_err'] = worst
    return row


def chain(dev):
    """The open loop's serial chain (``experiments/chain.py``, as
    ``kernel_first_check --chain`` prints it): the exact-math check (every
    result of csrc/exact_math.cuh equal to the library's), ns a substep on
    random and hover rows at B, one block and B=65536, the latencies of the
    chain's instruction classes on this card (csrc/latency_probe.cu), the SASS
    of the substep loops, the chain cycles of one substep (the per-step
    kernels' runtime-count loop) at those latencies, and the SM clock under
    load."""
    from safe_control_gym_tpu_torch.experiments import chain as ch
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    exact = rk.exact_math_check(dev)
    emit('chain', exact_math=exact)
    if any(differ for _, differ in exact.values()) or not all(n for n, _ in exact.values()):
        raise RuntimeError(f'csrc/exact_math.cuh differs from the CUDA math library: {exact}')
    clock = ch.sm_clock_ghz()
    probes, sass_rows, _ = ch.measured_chain(dev)
    for row in probes:
        emit('chain', latency=row)
        if not 1.0 <= row['cycles'] <= 200.0:
            raise RuntimeError(f'implausible latency reading {row}')
    for system, kernels in sass_rows.items():
        for fname, entry in kernels.items():
            if 'substep_loop' in entry:
                emit('chain', system=system, kernel=fname, substep_loop=entry['substep_loop'])
    cycles = ch.reference_chain_cycles(sass_rows)
    if set(cycles) != set(SYSTEMS):
        raise RuntimeError(f'no reference substep loop for {set(SYSTEMS) - set(cycles)}')
    fast_path = ch.compiled_in_fast_path(sass_rows)
    emit('chain', compiled_in_fast_path_per_substep=fast_path)
    if any(set(fast_path.get(s, {})) != {'advance', 'rollout'} for s in SYSTEMS):
        raise RuntimeError(f'a substep loop compiled for {N_SUB} substeps is missing: '
                           f'{fast_path}')
    times = ch.chain_times(dev)
    for row in times:
        emit('chain', **row)
    return dict(clock_ghz=clock, cycles=cycles, fast_path=fast_path,
                table_cycles=ch.reference_chain_cycles(sass_rows, 'chain_cycles_table'),
                latency={row['probe']: row['cycles'] for row in probes},
                times={(r['system'], r['case']): r for r in times})


# The whole-rollout rows of the reference benchmark (bench.py): plain and
# constrained for each system, and the cartpole tracking row.
ROLLOUT_ROWS = [('cartpole', False, False), ('cartpole', True, False),
                ('cartpole', False, True), ('quadrotor', False, False),
                ('quadrotor', True, False), ('quadrotor_3D', False, False),
                ('quadrotor_3D', True, False)]


def _counters():
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    return [getattr(pk, m['name']) for m in PHYSICS.values()] \
        + [getattr(rk, m['name']) for m in ROLLOUT.values()]


def _zero_launches():
    for fn in _counters():
        fn.launches = 0


def _launches(before=None):
    """Each kernel's launch count, less its count in ``before`` where given."""
    return {fn.__name__: fn.launches - (before[fn.__name__] if before else 0)
            for fn in _counters()}


def main_path(dev, smi):
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    _zero_launches()
    rows = {}
    for system in SYSTEMS:
        for constrained in (False, True):
            su, sps, ex = bs.measure_batched(system, constrained, batch=B,
                                             n_steps=T_PER_STEP, n_reps=2, device=dev)
            if not ex['mean_done_count'] > 0:
                raise RuntimeError(f'per-step path saw no episode end: {system} {ex}')
            rows[f'per_step {system} constrained={constrained}'] = dict(
                path=f'per-step ({PHYSICS[system]["id"]})', system=system, batch=B,
                T=T_PER_STEP, ctrl_steps_per_s=sps, speedup=su, card=smi, **ex)
    for system, constrained, tracking in ROLLOUT_ROWS:
        if not bs.kernel_covers(system, constrained, tracking, device=dev):
            raise RuntimeError(f'the rollout kernel does not cover the {system} config')
        su, sps, ex = bs.measure_rollout_kernel(system, constrained, batch=B,
                                                n_steps=T_ROLLOUT, n_reps=2,
                                                tracking=tracking, device=dev)
        rows[f'rollout {system} constrained={constrained} tracking={tracking}'] = dict(
            path=f'whole-rollout ({ROLLOUT[system]["id"]})', system=system, batch=B,
            T=T_ROLLOUT, ctrl_steps_per_s=sps, speedup=su, card=smi, **ex)
    launches = _launches()
    for row_name, row in rows.items():
        emit('main_path', row=row_name, **row)
    emit('main_path', launches=launches)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f'the main path never launched {name}')
    return launches, rows


def _welch(a, b, label, z=6.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    diff = abs(a.mean() - b.mean())
    ratio = a.var() / b.var() if min(a.var(), b.var()) > 1e-12 else 1.0
    ok = bool(diff <= z * se + 1e-9 and 0.5 < ratio < 2.0)
    emit('welch', stat=label, kernel_mean=a.mean(), per_step_mean=b.mean(), se=se,
         z=diff / se if se > 0 else 0.0, var_ratio=ratio, ok=ok)
    if not ok:
        raise RuntimeError(f'Welch check failed for {label}')


def welch(dev):
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    for system, constrained in (('cartpole', False), ('cartpole', True),
                                ('quadrotor', True), ('quadrotor_3D', True)):
        env = bs._make(system, constrained, device=dev)
        gen = torch.Generator(device=dev).manual_seed(23)
        states, _ = env.func.reset_batch(gen, B)
        cfg = bs._kernel_cfg(system, env, constrained)
        k = bs._kernel(system)[1](states.state.contiguous(), cfg, 11, T_WELCH,
                                  env.PYB_STEPS_PER_CTRL, env.PYB_TIMESTEP,
                                  constrained=constrained,
                                  randomized_reset=env.RANDOMIZED_INIT)
        lo = torch.as_tensor(env.action_space.low, device=dev)
        hi = torch.as_tensor(env.action_space.high, device=dev)
        actions = lo + torch.rand((T_WELCH, B, NU[system]), generator=gen, device=dev) * (hi - lo)
        _, s = bs.per_step_rollout(env, states, actions, gen)
        keys = ('reward_sum', 'done_count') + (('violation_count',) if constrained else ())
        if not float(k['done_count'].mean()) > 0:
            raise RuntimeError(f'stochastic {ROLLOUT[system]["name"]} saw no episode end')
        for key in keys:
            _welch((k[key] / T_WELCH).cpu().numpy(), (s[key] / T_WELCH).cpu().numpy(),
                   f'{system} constrained={constrained} {key}/step')


def _model_path(algo, system):
    return os.path.join(ROOT, 'examples', 'rl', 'models', algo,
                        f'{algo}_model_{system}_stab.pt')


def _policy_cases(system, dev, T=None):
    """(name, T, state0, cfg, kwargs) of the checked policy modes of
    ``system``: three modes with the committed actors of its PPO and SAC
    models on the benchmark env, the SAC actor on a ragged batch, a random
    actor whose H2 the kernel runs in chunks, then the launch inputs the
    closed loop builds (``fused_eval.kernel_inputs``) for each committed
    model whose config the kernel admits. ``T`` overrides every case's
    length."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.experiments import fused_eval as fe
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint
    from safe_control_gym_tpu_torch.utils.registration import make
    model_system = {v: k for k, v in MODEL_SYSTEM.items()}[system]
    layout = rk._C if system == 'cartpole' else rk._Q
    nx, nu = NX[system], NU[system]
    g = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    cases = []
    for name, algo, constrained in [('ppo_deterministic_obs_norm', 'ppo', False),
                                    ('sac_deterministic_relu_squash', 'sac', False),
                                    ('ppo_stochastic_constrained', 'ppo', True)]:
        params = load_checkpoint(_model_path(algo, model_system))['params']
        env = bs._make(system, constrained, device=dev)
        cfg = bs._kernel_cfg(system, env, constrained)
        states, _ = env.func.reset_batch(g, B)
        kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP, draw_actions=False,
                  constrained=constrained, randomized_reset=env.RANDOMIZED_INIT)
        if name == 'ppo_deterministic_obs_norm':
            # Frozen normalizer stats; the last dim's small variance makes
            # clip_obs bind.
            var = rng.uniform(0.5, 2.0, nx).astype(np.float32)
            var[-1] = 1e-4
            pp = rk.pack_policy_params(params['actor'], nx,
                                       obs_mean=rng.uniform(-0.1, 0.1, nx), obs_var=var,
                                       device=dev)
            kw.update(policy_activation='tanh', clip_obs=10.0)
        elif algo == 'sac':
            pp = rk.pack_policy_params(params['actor'], nx, device=dev)
            kw.update(policy_activation='relu', policy_squash=True)
        else:
            pp = rk.pack_policy_params(params['actor'], nx, device=dev)
            cfg[layout['P_STD']:layout['P_STD'] + nu] = torch.exp(
                torch.as_tensor(params['logstd'], device=dev))
            kw.update(policy_activation='tanh', policy_stochastic=True)
        kw['policy_params'] = pp
        cases.append((name, T or T_POLICY_CHECK[system], states.state.contiguous(), cfg, kw))
    # A batch whose last tile of envs is partly filled: the widest actor (W2
    # streamed), with action noise and Philox draws.
    params = load_checkpoint(_model_path('sac', model_system))['params']
    env = bs._make(system, True, device=dev)
    states, _ = env.func.reset_batch(g, B_RAGGED)
    cases.append(('ragged_batch_sac_constrained', T or T_POLICY_CHECK[system],
                  states.state.contiguous(), bs._kernel_cfg(system, env, True),
                  dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                       draw_actions=False, constrained=True,
                       randomized_reset=env.RANDOMIZED_INIT,
                       policy_params=rk.pack_policy_params(params['actor'], nx, device=dev),
                       policy_activation='relu', policy_squash=True)))
    # An actor too wide for the h2 of 32 envs: a random 384 -> 1000 one, W2
    # streamed and H2 run in chunks (the last one narrower), stochastic.
    widths = (nx, *CHUNKED_WIDTHS, 2 * nu)
    actor = [{'w': (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
              'b': (0.1 * rng.standard_normal(b)).astype(np.float32)}
             for a, b in zip(widths[:-1], widths[1:])]
    cfg = bs._kernel_cfg(system, env, True)
    cfg[layout['P_STD']:layout['P_STD'] + nu] = 0.3
    cases.append(('chunked_h2_stochastic', T or T_CHUNKED, states.state.contiguous(), cfg,
                  dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                       draw_actions=False, constrained=True,
                       randomized_reset=env.RANDOMIZED_INIT,
                       policy_params=rk.pack_policy_params(actor, nx, device=dev),
                       policy_activation='relu', policy_stochastic=True,
                       policy_squash=True)))
    if model_system == 'quadrotor_2D':     # the gates send it to the per-step path
        return cases
    for algo, stochastic in (('ppo', False), ('ppo', True), ('sac', False)):
        env_id, task_config, algo_config = eval_config(algo, model_system)
        ctrl = make(algo, functools.partial(make, env_id, device=dev, **task_config),
                    **algo_config)
        ctrl.load(_model_path(algo, model_system))
        spec = fe.policy_eval_spec(ctrl, ctrl.env, stochastic=stochastic)
        s0, cfg, kw = fe.kernel_inputs(spec, ctrl.env, B, 0, stochastic)
        ctrl.close()
        name = f'committed_{algo}_{model_system}_stab' + ('_stochastic' if stochastic else '')
        cases.append((name, T or T_COMMITTED, s0, cfg, kw))
    return cases


def mlp_ops(pp, nu):
    """Operations of one actor forward as the kernel runs it: 2 (nx H1 +
    H1 H2 + H2 nu) for the products and sums (of the nu_out outputs only the
    first nu are computed), the biases and activations, and the
    normalization."""
    return (2 * (pp.nx * pp.h1 + pp.h1 * pp.h2 + pp.h2 * nu)
            + 2 * (pp.h1 + pp.h2) + nu + 4 * pp.nx)


def policy_rollout_ops(system, kw, T, done_total=0.0, batch=B):
    """Operations of a ``batch``-env, T-step rollout in policy mode ``kw``."""
    nu = NU[system]
    per_step = mlp_ops(kw['policy_params'], nu)
    if kw.get('policy_stochastic'):
        if system == 'cartpole':
            per_step += OPS_STEP_REST['box_muller']
            if not kw.get('constrained'):
                per_step += OPS_PHILOX + OPS_STEP_REST['uniform']
        else:
            per_step += OPS_PHILOX + OPS_UNIFORM4 + nu // 2 * 13
    if kw.get('policy_squash'):
        per_step += nu
    return rollout_ops(system, kw, T, done_total, batch) + batch * T * per_step


def policy_rollout_bytes(system, kw, T, batch=B):
    """Bytes of a policy-mode rollout: the open-loop ones and the actor's
    weights the kernel reads (the first nu columns of W3 and b3)."""
    pp, nu = kw['policy_params'], NU[system]
    floats = (2 * pp.nx + pp.nx * pp.h1 + pp.h1 + pp.h1 * pp.h2 + pp.h2
              + pp.h2 * nu + nu)
    return rollout_bytes(system, kw, T, batch) + floats * 4


def actor_library_ms(pp, nu, activation, T, dev, batch=B):
    """A yardstick, never called by the port: the actor alone on ``batch``
    random obs as three ``torch.addmm`` and the activation (the first ``nu``
    outputs, TF32 off), captured in a CUDA graph; one replay's device time
    times T."""
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    _, _, w1, b1, w2, b2, w3, b3 = rk._policy_views(pp)
    w3, b3 = w3[:, :nu].contiguous(), b3[:nu].contiguous()
    act = torch.tanh if activation == 'tanh' else torch.relu
    obs = torch.randn((batch, pp.nx), generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)

    def forward():
        h = act(torch.addmm(b1, obs, w1))
        return torch.addmm(b3, act(torch.addmm(b2, h, w2)), w3)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            forward()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        forward()
    return time_ms(graph.replay, 50) * T


def check_policy(system, dev, length=None):
    """K4 or K5 in policy mode against its plain version on every case of
    ``_policy_cases``, timed; the SAC case (the widest actor) gives the
    kernels line's times. ``length`` overrides every case's T."""
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import _kernel
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    meta = ROLLOUT[system]
    kernel, plain = _kernel(system)[1], _plain_rollout(system)
    phase = meta['id'].lower() + '_policy'
    worst = 0.0
    cases = {}
    for name, T, s0, cfg, kw in _policy_cases(system, dev, length):
        k = kernel(s0, cfg, 7, T, **kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p = plain(s0, cfg, 7, T, **kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        state_err = float((k['state'] - p['state']).abs().max())
        rew_err = float((k['reward_sum'] - p['reward_sum']).abs().max())
        flips = {key: int((k[key] != p[key]).sum())
                 for key in ('done_count', 'ctrl_step', 'violation_count')}
        ok = (state_err <= 1e-4 and bool(((k['reward_sum'] - p['reward_sum']).abs()
                                           <= 1e-4 + 1e-4 * p['reward_sum'].abs()).all())
              and not any(flips.values()))
        pp = kw['policy_params']
        n_envs = s0.shape[0]
        ms = time_ms(lambda: kernel(s0, cfg, 8, T, **kw), 3)
        done_total = float(k['done_count'].sum())
        n_ops = policy_rollout_ops(system, kw, T, done_total, n_envs)
        b_ms, b_by = bound_ms(policy_rollout_bytes(system, kw, T, n_envs), n_ops)
        # Without fused multiply-adds each one is two instructions: the
        # kernel can at best take twice the operations bound.
        ceiling_ms = 2 * n_ops / PEAK_OPS_PER_S * 1e3
        # One block (its 32 envs) against the full batch: the same time
        # means one block's serial chain sets the pace.
        block_s0 = s0[:rk._POLICY_ENVS].contiguous()
        one_block_ms = time_ms(lambda: kernel(block_s0, cfg, 8, T, **kw), 3)
        cases[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           us_per_step=ms * 1e3 / T, share_of_bound=b_ms / ms,
                           f32_ceiling_ms=ceiling_ms, share_of_ceiling=ceiling_ms / ms,
                           actor_library_ms=actor_library_ms(
                               pp, NU[system], kw['policy_activation'], T, dev, n_envs),
                           one_block_ms=one_block_ms, T=T, B=n_envs,
                           actor=f'{pp.nx}->{pp.h1}->{pp.h2}->{pp.nu_out}')
        min_done = float(k['done_count'].min())
        emit(phase, kernel=meta['name'], case=name, state_err=state_err,
             reward_err=rew_err, envs_with_other_counts=flips, ok=ok,
             mean_done_count=float(k['done_count'].mean()), min_done_count=min_done,
             mean_violation_count=float(k['violation_count'].mean()), **cases[name])
        if name.startswith('committed') and T >= T_COMMITTED and min_done < 1:
            raise RuntimeError(f'{meta["name"]} on {name}: an env drew no fresh state '
                               f'in {T} steps, so the check missed the reset draws')
        if not ok:
            raise RuntimeError(
                f'{meta["name"]} in policy mode disagrees with its plain version on {name}: '
                f'state err {state_err} (tol 1e-4), reward err {rew_err} (tol 1e-4 + '
                f'1e-4|r|), envs whose counts differ {flips} (must be none)')
        worst = max(worst, state_err, rew_err)
    sac = cases['sac_deterministic_relu_squash']
    return dict(name=meta['name'] + ' (policy mode)', route='cuda',
                source=meta['source'] + ' + ' + SRC + 'policy_mlp.cuh',
                replaces=meta['replaces'], max_abs_err=worst, ms=sac['ms'],
                kernel_ms=sac['ms'], plain_ms=sac['plain_ms'], bound_ms=sac['bound_ms'],
                bound_by=sac['bound_by'], library_ms=None,
                library_note='none: no single PyTorch call computes a closed-loop '
                             'T-step env rollout; actor_library_ms times the actor alone',
                actor_library_ms=sac['actor_library_ms'], f32_ceiling_ms=sac['f32_ceiling_ms'],
                one_block_ms=sac['one_block_ms'],
                shape=f'B={B} T={sac["T"]} deterministic SAC actor {sac["actor"]}',
                cases=cases, id=meta['id'])


def _policy_counts():
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    counts = _launches()
    counts.update({f'{m["name"]}.policy': getattr(rk, m['name']).policy_launches
                   for m in ROLLOUT.values()})
    return counts


def closed_loop(dev, smi):
    """The slice's main path: the committed PPO and SAC models through
    make -> load -> evaluate_fused at B=4096, then the closed-loop bench rows."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    from safe_control_gym_tpu_torch.utils.registration import make
    _zero_launches()
    for m in ROLLOUT.values():
        getattr(rk, m['name']).policy_launches = 0
    rows = {}
    for algo, model_system in MODELS:
        system = MODEL_SYSTEM[model_system]
        env_id, task_config, algo_config = eval_config(algo, model_system)
        before = _policy_counts()
        ctrl = make(algo, functools.partial(make, env_id, device=dev, **task_config),
                    **algo_config)
        ctrl.load(_model_path(algo, model_system))
        res = ctrl.evaluate_fused(batch=B, n_steps=T_CLOSED, seed=0)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in _policy_counts().items() if v != before[k]}
        widths = [tuple(layer['w'].shape) for layer in ctrl.agent.params['actor']]
        ctrl.close()
        # quadrotor_2D_stab's state box is not the default one: the kernel's
        # gate refuses it, and the per-step path (K2) runs it.
        kernel_row = model_system != 'quadrotor_2D'
        want = 'policy-in-kernel' if kernel_row else 'per-step-scan'
        row = dict(path=res['path'], algo=algo, system=model_system, actor=widths, batch=B,
                   T=T_CLOSED, ctrl_steps_per_s=res['steps_per_sec'],
                   episodes=res['episodes'], ep_return_mean=res['ep_return_mean'],
                   ep_length_mean=res['ep_length_mean'], launches_moved=moved, card=smi)
        rows[f'{algo} {model_system}'] = row
        emit('closed_loop', **row)
        if res['path'] != want:
            raise RuntimeError(f'{algo} {model_system} took path {res["path"]}, expected {want}')
        policy_key = f'{ROLLOUT[system]["name"]}.policy'
        if kernel_row and moved.get(policy_key, 0) < 1:
            raise RuntimeError(f'{algo} {model_system}: {policy_key} did not launch')
        if not kernel_row and (moved.get(PHYSICS[system]['name'], 0) < T_CLOSED
                               or moved.get(policy_key, 0)):
            raise RuntimeError(f'{algo} {model_system}: the per-step path did not run '
                               f'through {PHYSICS[system]["name"]} alone: {moved}')
        if not (res['episodes'] > 0 and np.isfinite(res['ep_return_mean'])
                and 0 < res['ep_length_mean'] <= T_CLOSED):
            raise RuntimeError(f'{algo} {model_system}: implausible statistics {res}')
    for system, hidden, activation, out_mult, T in CLOSED_BENCH:
        sps, ex = bs.measure_closed_loop_kernel(system, batch=B, n_steps=T,
                                                n_reps=3 if T > 4096 else 2, hidden=hidden,
                                                activation=activation,
                                                nu_out=out_mult * NU[system], device=dev)
        key = f'bench {system} hidden={hidden}'
        rows[key] = dict(path=f'policy-in-kernel ({ROLLOUT[system]["id"]})', system=system,
                         batch=B, T=T, ctrl_steps_per_s=sps, card=smi, **ex)
        emit('closed_loop', row=key, **rows[key])
    launches = _policy_counts()
    emit('closed_loop', launches=launches)
    for m in ROLLOUT.values():
        if launches[f'{m["name"]}.policy'] <= 0:
            raise RuntimeError(f'the closed-loop path never launched {m["name"]} in '
                               'policy mode')
    return launches, rows


def welch_closed_loop(dev):
    """Stochastic PPO, the committed cartpole and 3D quad models: per-env
    reward and done counts of the kernel path against the per-step path."""
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils.registration import make
    for model_system in ('cartpole', 'quadrotor_3D'):
        env_id, task_config, algo_config = eval_config('ppo', model_system)
        ctrl = make('ppo', functools.partial(make, env_id, device=dev, **task_config),
                    **algo_config)
        ctrl.load(_model_path('ppo', model_system))
        kw = dict(batch=B, n_steps=T_WELCH_CLOSED, stochastic=True, n_reps=0,
                  return_per_env=True)
        rk = ctrl.evaluate_fused(seed=11, use_kernel=True, **kw)
        rs = ctrl.evaluate_fused(seed=23, use_kernel=False, **kw)
        ctrl.close()
        if rk['path'] != 'policy-in-kernel' or rs['path'] != 'per-step-scan':
            raise RuntimeError(f'welch_closed_loop took {rk["path"]} and {rs["path"]}')
        if not (rk['episodes'] > 0 and rs['episodes'] > 0):
            raise RuntimeError(f'welch_closed_loop: no episode ended ({model_system})')
        for key in ('reward_sum', 'done_count'):
            _welch(rk['per_env'][key] / T_WELCH_CLOSED, rs['per_env'][key] / T_WELCH_CLOSED,
                   f'closed loop stochastic PPO {model_system} {key}/step')


def _ppo(system, dev, out_dir, iterations=None):
    """The committed PPO config of ``system`` on the card, from seed 0, cut
    to ``iterations`` training iterations where given."""
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils.registration import make
    env_id, task_config, algo_config = eval_config('ppo', system)
    if iterations is not None:
        algo_config = dict(algo_config, max_env_steps=iterations * int(
            algo_config['rollout_batch_size']) * int(algo_config['rollout_steps']))
    ctrl = make('ppo', functools.partial(make, env_id, device=dev, **task_config),
                training=True, output_dir=os.path.join(out_dir, system), seed=0,
                **algo_config)
    return ctrl, algo_config


def _train(ctrl):
    """reset + learn, timed on the host; returns the wall seconds."""
    t0 = time.perf_counter()
    ctrl.reset()
    ctrl.learn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _update_card_against_cpu(ctrl):
    """One update (opt_epochs x minibatches) on a batch of a fresh rollout of
    the card, run by the card's agent and by a copy on the CPU, on the same
    permutations; returns the largest parameter difference and both counts
    of accepted actor steps."""
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import PPOAgent
    from safe_control_gym_tpu_torch.math.optim import tree_leaves
    batch, _ = ctrl.rollout()
    m = batch['obs'].shape[0]
    _, _, used = ctrl.agent.minibatch_plan(m)
    cpu_gen = torch.Generator().manual_seed(0)
    perms = [torch.randperm(m, generator=cpu_gen)[:used] for _ in range(int(ctrl.opt_epochs))]
    cpu = PPOAgent(ctrl.env.observation_space, ctrl.env.action_space, device='cpu',
                   **{k: getattr(ctrl, k) for k in (
                       'hidden_dim', 'use_clipped_value', 'clip_param', 'target_kl',
                       'entropy_coef', 'actor_lr', 'critic_lr', 'opt_epochs',
                       'mini_batch_size', 'activation', 'max_grad_norm')})
    cpu.load_state_dict(ctrl.agent.state_dict())
    counts0 = int(ctrl.agent.actor_opt_state['count'])
    card_losses = ctrl.agent.update(batch, perms=perms)
    cpu_losses = cpu.update({k: v.cpu() for k, v in batch.items()}, perms=perms)
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(tree_leaves(ctrl.agent.params), tree_leaves(cpu.params)))
    return dict(max_abs_err=err, rows=m, rows_used=used,
                accepted_card=int(ctrl.agent.actor_opt_state['count']) - counts0,
                accepted_cpu=int(cpu.actor_opt_state['count']) - counts0,
                losses_card=card_losses, losses_cpu=cpu_losses)


def _profiled(fn, cpu_activity=True):
    """Run ``fn`` under ``torch.profiler``: host seconds to the last
    synchronize, the device's busy seconds (its kernels' time) and the
    kernels launched. Without ``cpu_activity`` the profiler records the
    card's activity alone. The card's events are read from the profiler's
    raw results: building its event tree (``key_averages``) takes seconds
    for the tens of thousands of kernels of a certification."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu_activity else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    return wall, sum(e.duration_ns() for e in kernels) / 1e9, len(kernels)


def _training_trace(ctrl):
    """A rollout of T_TRACE steps and one epoch of minibatch steps on its
    batch, each under the profiler (after a rollout to take the batch from):
    host and device-busy seconds of each, and kernels a rollout step and a
    minibatch."""
    T, ctrl.T = ctrl.T, T_TRACE
    batch, _ = ctrl.rollout()
    torch.cuda.synchronize()
    _, num_mb, _ = ctrl.agent.minibatch_plan(batch['obs'].shape[0])
    epochs, ctrl.agent.opt_epochs = ctrl.agent.opt_epochs, 1
    # The card's activity alone: the host's events cost seconds to collect.
    r_wall, r_busy, r_kernels = _profiled(ctrl.rollout, cpu_activity=False)
    u_wall, u_busy, u_kernels = _profiled(
        lambda: ctrl.agent.update_tensors(batch, ctrl.gen), cpu_activity=False)
    ctrl.agent.opt_epochs = epochs
    row = dict(window=f'one rollout (T={ctrl.T}) and one epoch ({num_mb} minibatches), '
                      'each under torch.profiler',
               rollout_s=r_wall, rollout_device_busy_s=r_busy, rollout_kernels=r_kernels,
               kernels_per_step=r_kernels / ctrl.T, epoch_s=u_wall,
               epoch_device_busy_s=u_busy, epoch_kernels=u_kernels,
               kernels_per_minibatch=u_kernels / num_mb,
               device_busy_share=(r_busy + u_busy) / (r_wall + u_wall))
    ctrl.T = T
    return row


def ppo_train(dev, smi):
    """The slice's main path: PPO training on the card through the entry
    points, K1-K3 stepping every rollout step; see the module docstring."""
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    losses = ('policy_loss', 'value_loss', 'entropy_loss', 'approx_kl')
    rows = {}
    with tempfile.TemporaryDirectory() as out_dir:
        ctrl, algo = _ppo('cartpole', dev, out_dir)
        _zero_launches()
        wall = _train(ctrl)
        learn_launches = pk.cartpole_advance.launches
        t0 = time.perf_counter()
        res = ctrl.run(n_episodes=10)
        eval_s = time.perf_counter() - t0
        launches = _launches()
        steps_per_iter = ctrl.N * ctrl.T
        iterations = ctrl.total_steps // steps_per_iter
        eval_steps = ctrl.eval_env.func.max_steps + 1
        want = iterations * ctrl.T + eval_steps
        eval_return = float(res['ep_returns'].mean())
        last = ctrl.last_results
        row = dict(system='cartpole', envs=ctrl.N, T=ctrl.T, hidden=int(ctrl.hidden_dim),
                   iterations=iterations, total_steps=ctrl.total_steps,
                   max_env_steps=int(algo['max_env_steps']), wall_s=wall,
                   rollout_s=ctrl.train_seconds['rollout'],
                   update_s=ctrl.train_seconds['update'],
                   seconds_per_iteration=wall / iterations,
                   env_steps_per_s=ctrl.total_steps / wall, eval_s=eval_s,
                   last_iteration={k: last[k] for k in losses + ('mean_reward',)},
                   eval_return=eval_return, eval_returns=res['ep_returns'].tolist(),
                   eval_lengths=res['ep_lengths'].tolist(), eval_bar=PPO_EVAL_BAR,
                   k1_launches=launches['cartpole_advance'],
                   k1_launches_learn=learn_launches, k1_launches_expected=want,
                   launches=launches, card=smi)
        rows['cartpole'] = row
        emit('ppo_train', **row)
        if not all(np.isfinite(last[k]) for k in losses):
            raise RuntimeError(f'ppo_train cartpole: a loss is not finite: {last}')
        if ctrl.total_steps < int(algo['max_env_steps']):
            raise RuntimeError(f'ppo_train cartpole stopped at {ctrl.total_steps} steps')
        if launches['cartpole_advance'] != want or learn_launches != iterations * ctrl.T:
            raise RuntimeError(f'ppo_train cartpole: K1 launched {launches}, expected {want}')
        if not eval_return >= PPO_EVAL_BAR:
            raise RuntimeError(f'ppo_train cartpole: eval return {eval_return} under the '
                               f'bar {PPO_EVAL_BAR}')
        upd = _update_card_against_cpu(ctrl)
        emit('ppo_train', part='update card against CPU', atol=PPO_UPDATE_ATOL, **upd)
        rows['update'] = upd
        if not upd['max_abs_err'] <= PPO_UPDATE_ATOL:
            raise RuntimeError(f'ppo_train: the card\'s update differs from the CPU\'s: {upd}')
        rows['trace'] = _training_trace(ctrl)
        emit('ppo_train', part='trace', card=smi, **rows['trace'])
        ctrl.close()
        for system, kernel in (('quadrotor_2D', 'quad2d_advance'),
                               ('quadrotor_3D', 'quad3d_advance')):
            ctrl, _ = _ppo(system, dev, out_dir, iterations=PPO_QUAD_ITERATIONS)
            _zero_launches()
            wall = _train(ctrl)
            launches = _launches()
            iterations = ctrl.total_steps // (ctrl.N * ctrl.T)
            last = ctrl.last_results
            row = dict(system=system, envs=ctrl.N, T=ctrl.T, hidden=int(ctrl.hidden_dim),
                       iterations=iterations, total_steps=ctrl.total_steps, wall_s=wall,
                       rollout_s=ctrl.train_seconds['rollout'],
                       update_s=ctrl.train_seconds['update'],
                       seconds_per_iteration=wall / iterations,
                       env_steps_per_s=ctrl.total_steps / wall,
                       last_iteration={k: last[k] for k in losses + ('mean_reward',)},
                       launches=launches, card=smi)
            rows[system] = row
            emit('ppo_train', **row)
            ctrl.close()
            if not all(np.isfinite(last[k]) for k in losses):
                raise RuntimeError(f'ppo_train {system}: a loss is not finite: {last}')
            if iterations != PPO_QUAD_ITERATIONS or launches[kernel] != iterations * ctrl.T \
                    or sum(launches.values()) != launches[kernel]:
                raise RuntimeError(f'ppo_train {system}: launches {launches}, expected '
                                   f'{iterations * ctrl.T} of {kernel} alone')
    return rows


def _bit_checks(dev, phase, cases):
    """Each (system, batch, n_substeps, dt) of ``cases``: the kernel on random
    inputs bit for bit against its plain version, and its time."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    rows = {}
    for system, batch, n_sub, dt in cases:
        meta = PHYSICS[system]
        kernel, plain = getattr(pk, meta['name']), getattr(pk, meta['name'] + '_plain')
        args = (*bs.physics_args(system, dev, batch, seed=4), n_sub, dt)
        err = float((kernel(*args) - plain(*args)).abs().max())
        torch.cuda.synchronize()
        row = dict(kernel=meta['name'], B=batch, n_substeps=n_sub, max_abs_err=err, tol=0.0,
                   ms=time_ms(lambda: kernel(*args), 200))
        rows[f'{meta["id"]} B={batch} n_substeps={n_sub}'] = row
        emit(phase, part=f'kernel at the {phase} substeps', **row)
        if err != 0.0:
            raise RuntimeError(f'{meta["id"]} at B={batch}, {n_sub} substeps disagrees with '
                               f'its plain version: {err}')
    return rows


def _control_kernel_checks(dev):
    """K1 at 50 substeps (15 Hz over 750 Hz) and K2 at 4 (60 over 240), the
    counts of the control configs, bit for bit against their plain versions
    at B=4096 and at the stateful loops' B=1; the Riccati solvers and expm on
    the card against scipy on tests/test_linalg.py's systems (its tolerances:
    np.allclose, rtol 1e-5 plus atol 1e-4, 1e-4 and 2e-4); and the cost of
    torch.linalg.eigh (which waits for the card) against iLQR's closed-form
    inverse of H, for (B, 2, 2)."""
    import scipy.linalg as sla
    from safe_control_gym_tpu_torch.controllers.lqr.ilqr import _regularized_inverse
    from safe_control_gym_tpu_torch.math import linalg
    rows = _bit_checks(dev, 'control', [(system, batch, n_sub, dt) for system, n_sub, dt in
                                        (('cartpole', 50, 1.0 / 750), ('quadrotor', 4, 1.0 / 240))
                                        for batch in (B, 1)])
    rng = np.random.default_rng(0)
    systems = [(rng.standard_normal((4, 4)) * 0.5, rng.standard_normal((4, 2)))
               for _ in range(4)]
    A = torch.tensor(np.stack([a for a, _ in systems]), dtype=torch.float32, device=dev)
    Bm = torch.tensor(np.stack([b for _, b in systems]), dtype=torch.float32, device=dev)
    Q, R = np.eye(4), np.eye(2) * 0.1
    got = {'solve_dare': linalg.solve_dare(A, Bm, Q, R), 'solve_care': linalg.solve_care(A, Bm, Q, R),
           'expm': linalg.expm(A)}
    want = {'solve_dare': [sla.solve_discrete_are(a, b, Q, R) for a, b in systems],
            'solve_care': [sla.solve_continuous_are(a, b, Q, R) for a, b in systems],
            'expm': [sla.expm(a) for a, _ in systems]}
    for name, atol in (('solve_dare', 1e-4), ('solve_care', 1e-4), ('expm', 2e-4)):
        card_out = got[name].cpu().numpy()
        err = max(float(np.abs(c - w).max()) for c, w in zip(card_out, want[name]))
        ok = all(np.allclose(c, w, rtol=1e-5, atol=atol) for c, w in zip(card_out, want[name]))
        rows[name] = dict(max_abs_err_vs_scipy=err, atol=atol, rtol=1e-5, ok=ok)
        emit('control', part='linalg on the card against scipy', function=name, **rows[name])
        if not ok:
            raise RuntimeError(f'{name} on the card disagrees with scipy: {err}')
    g = torch.Generator(device=dev).manual_seed(0)
    M = torch.randn((B, 2, 2), generator=g, device=dev)
    H = M @ M.transpose(1, 2) + 0.1 * torch.eye(2, device=dev)
    lamb = torch.ones(B, device=dev)
    per_call = lambda fn: time_ms(fn, 50, primed=False)
    closed_ms = per_call(lambda: _regularized_inverse(H, lamb))

    def eigh_inverse():
        evals, evecs = torch.linalg.eigh(H)
        evals = torch.clamp(evals, min=0.0) + lamb[:, None]
        return (evecs * (1.0 / evals)[:, None, :]) @ evecs.transpose(1, 2)
    eigh_ms = per_call(eigh_inverse)
    err = float((_regularized_inverse(H, lamb) - eigh_inverse()).abs().max())
    rows['inverse_of_H'] = dict(B=B, nu=2, closed_form_ms=closed_ms, eigh_ms=eigh_ms,
                                max_abs_diff=err, timing='host clock over 50 back-to-back '
                                'calls ending in a synchronize (eigh waits for the card)')
    emit('control', part='inverse of H: closed form against eigh', **rows['inverse_of_H'])
    return rows


def _closed_loop_record(ctrl, env):
    """One episode of ``ctrl`` on ``env``: observations, infos and actions."""
    obs, info = env.reset()
    observations, infos, actions = [obs], [info], []
    done = False
    while not done:
        action = ctrl.select_action(obs, info)
        obs, _, done, info = env.step(action)
        observations.append(obs)
        infos.append(info)
        actions.append(np.asarray(action))
    return np.array(observations), infos, np.array(actions)


def control(dev, smi):
    """The slice's main path: make('ilqr' | 'lqr' | 'pid', partial(make, env,
    device='cuda', ...)) through the entry points, K1-K3 stepping every
    closed loop; see the module docstring."""
    from safe_control_gym_tpu_torch.experiments.control_configs import control_config
    from safe_control_gym_tpu_torch.utils.registration import get_config, make
    t_phase = time.perf_counter()
    checks = _control_kernel_checks(dev)
    _, quad_task, quad_algo = control_config('ilqr', 'quadrotor_2D', 'stab')
    quad_task = dict(quad_task, episode_len_sec=ILQR_QUAD_EPISODE_SEC)
    solves = [('cartpole', 'cartpole', ILQR_DEMO_TASK, dict(get_config('ilqr'), max_iterations=10),
               'examples/lqr/batched_ilqr_demo.py', 0.2, True),
              ('quadrotor_2D', 'quadrotor', quad_task, quad_algo,
               'examples/lqr/config_overrides/quadrotor_2D/ilqr_quadrotor_2D_stab.yaml', 0.1,
               False)]
    ctrls = {name: make('ilqr', functools.partial(make, env_id, device=dev, **task), **algo)
             for name, env_id, task, algo, *_ in solves}
    # One iteration of two problems first: torch.func's first use is set-up.
    warm = ctrls['cartpole']
    warm.max_iterations, iterations = 1, warm.max_iterations
    warm.solve_batch(np.repeat(warm.env._nominal_init_state()[None], 2, axis=0))
    warm.max_iterations = iterations
    rows = {}
    _zero_launches()
    for name, env_id, task, algo, source, spread, strict in solves:
        ctrl = ctrls[name]
        nominal = np.asarray(ctrl.env._nominal_init_state(), np.float32)
        x0s = nominal + np.random.default_rng(0).uniform(
            -spread, spread, (B_CONTROL, nominal.shape[0])).astype(np.float32)
        before = _launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ctrl.solve_batch(x0s)
        seconds = time.perf_counter() - t0
        moved = _launches(before)
        G = CONTROL_GATE_ROWS
        cpu = make('ilqr', functools.partial(make, env_id, device='cpu', **task), **algo)
        t0 = time.perf_counter()
        ref = cpu.solve_batch(x0s[:G])
        cpu_seconds = time.perf_counter() - t0
        ref_moved = cpu.solve_batch(x0s[:G] + np.float32(CONTROL_PERTURB))
        t0 = time.perf_counter()
        reeval = cpu.evaluate_batch(x0s, out['gains_fb'], out['input_ff'])
        reeval_seconds = time.perf_counter() - t0
        reeval_err = float(np.max(np.abs(reeval - out['cost']) / np.abs(out['cost'])))
        T, kname = ctrl.env.CTRL_STEPS, PHYSICS['cartpole' if name == 'cartpole'
                                                   else 'quadrotor']['name']
        card_rows = {k: v[:G] for k, v in out.items()}
        same = lambda a, b: (np.isclose(a['cost'], b['cost'], rtol=CONTROL_RTOL,
                                        atol=CONTROL_RTOL) & (a['iterations'] == b['iterations']))
        agree_share = float(same(card_rows, ref).mean())
        cpu_self_share = float(same(ref_moved, ref).mean())
        errs = {k: float(np.abs(card_rows[k] - ref[k]).max())
                for k in ('cost', 'cost_curves', 'gains_fb', 'input_ff')}
        close = {k: bool(np.allclose(card_rows[k], ref[k], rtol=CONTROL_RTOL,
                                     atol=CONTROL_RTOL)) for k in errs}
        equal = {k: bool(np.array_equal(card_rows[k], ref[k]))
                 for k in ('iterations', 'converged', 'aborted')}
        row = dict(system=name, source=source, B=B_CONTROL, T=T,
                   n_substeps=ctrl.env.PYB_STEPS_PER_CTRL, max_iterations=ctrl.max_iterations,
                   seconds=seconds, problems_per_s=B_CONTROL / seconds,
                   converged_share=float(out['converged'].mean()),
                   aborted_share=float(out['aborted'].mean()),
                   iterations_mean=float(out['iterations'].mean()),
                   cost_mean=float(out['cost'].mean()), launches=moved,
                   launches_expected={kname: ctrl.max_iterations * T},
                   gate='every row equal' if strict else
                   f'at least {CONTROL_AGREE_SHARE} of the rows equal',
                   gate_rows=G, cpu_seconds=cpu_seconds, max_abs_err=errs, within_rtol=close,
                   equal=equal, rows_agreeing_share=agree_share,
                   cpu_rows_unmoved_by_perturbation_share=cpu_self_share,
                   perturbation=CONTROL_PERTURB, reeval_max_rel_err=reeval_err,
                   reeval_rows=B_CONTROL, reeval_cpu_seconds=reeval_seconds,
                   gain_card_vs_cpu=float(np.abs(ctrl.gain - cpu.gain).max()), card=smi)
        rows[f'ilqr {name}'] = row
        emit('control', part='ilqr solve_batch', **row)
        if not np.isfinite(out['cost']).all():
            raise RuntimeError(f'control ilqr {name}: a cost is not finite')
        if moved[kname] != ctrl.max_iterations * T or sum(moved.values()) != moved[kname]:
            raise RuntimeError(f'control ilqr {name}: launches {moved}, expected '
                               f'{ctrl.max_iterations * T} of {kname} alone')
        if not reeval_err <= CONTROL_RTOL:
            raise RuntimeError(f'control ilqr {name}: the card\'s policies cost otherwise in a '
                               f'CPU rollout: {reeval_err}')
        if strict and not (all(close.values()) and all(equal.values())):
            raise RuntimeError(f'control ilqr {name}: the card\'s solve differs from the CPU\'s '
                               f'on the first {G} problems: {errs} {equal}')
        if not strict and not agree_share >= CONTROL_AGREE_SHARE:
            raise RuntimeError(f'control ilqr {name}: {agree_share} of the first {G} problems '
                               f'agree with the CPU\'s solve (gate {CONTROL_AGREE_SHARE})')
    # LQR on the cartpole stab example, card and CPU each in its own loop.
    env_id, task, algo = control_config('lqr', 'cartpole', 'stab')
    task = dict(task, randomized_init=False, init_state={'init_x': 0.3, 'init_theta': 0.05})
    runs = {}
    for d in (dev, 'cpu'):
        ctrl = make('lqr', functools.partial(make, env_id, device=d, **task), **algo)
        t0 = time.perf_counter()
        runs[str(d)] = (*_closed_loop_record(ctrl, make(env_id, device=d, **task)),
                        time.perf_counter() - t0, ctrl.gain)
    (cs, _, ca, c_sec, c_gain), (hs, _, ha, h_sec, h_gain) = runs[str(dev)], runs['cpu']
    same_len = cs.shape == hs.shape
    row = dict(system='cartpole', source='examples/lqr/config_overrides/cartpole/'
               'lqr_cartpole_stab.yaml', steps=len(ca), n_substeps=50, seconds=c_sec,
               cpu_seconds=h_sec, state_max_abs_err=float(np.abs(cs - hs).max())
               if same_len else None, action_max_abs_err=float(np.abs(ca - ha).max())
               if same_len else None, gain_card_vs_cpu=float(np.abs(c_gain - h_gain).max()),
               atol=CONTROL_ATOL, card=smi)
    rows['lqr cartpole'] = row
    emit('control', part='lqr closed loop, card against CPU', **row)
    if not (same_len and row['state_max_abs_err'] <= CONTROL_ATOL):
        raise RuntimeError(f'control lqr cartpole: card and CPU loops differ: {row}')
    # PID on the 3D tracking example: the card's loop recorded, then the CPU's
    # PID on its observations and the CPU's env on each of its steps (the
    # loop, and a replay of its actions, amplify float32 rounding: see
    # tests/test_torch_control.py).
    env_id, task, algo = control_config('pid', 'quadrotor_3D', 'track')
    task = dict(task, randomized_init=False, init_state={'init_z': 1.0})
    ctrl = make('pid', functools.partial(make, env_id, device=dev, **task), **algo)
    t0 = time.perf_counter()
    obs, infos, actions = _closed_loop_record(ctrl, make(env_id, device=dev, **task))
    seconds = time.perf_counter() - t0
    cpu = make('pid', functools.partial(make, env_id, device='cpu', **task), **algo)
    cpu_actions = np.array([cpu.select_action(o, i) for o, i in zip(obs[:-1], infos[:-1])])
    # Each step of the CPU's env from the card's state under the card's action.
    cpu_env = make(env_id, device='cpu', **task)
    est, _ = cpu_env.func.reset_batch(cpu_env.generator, len(actions))
    est = est.replace(state=torch.tensor(obs[:-1]),
                      ctrl_step=torch.arange(len(actions), dtype=torch.int32))
    cpu_next = cpu_env.func.step(est, torch.tensor(actions, dtype=torch.float32))[1].obs
    row = dict(system='quadrotor_3D', source='examples/pid/config_overrides/quadrotor_3D/'
               'quadrotor_3D_track.yaml', steps=len(actions), n_substeps=20, seconds=seconds,
               action_max_abs_err=float(np.abs(cpu_actions - actions).max()),
               state_max_abs_err=float(np.abs(cpu_next.numpy() - obs[1:]).max()),
               compared='each step from the card\'s state and action', atol=CONTROL_ATOL,
               card=smi)
    rows['pid quadrotor_3D'] = row
    emit('control', part='pid closed loop, card against CPU', **row)
    if not (row['state_max_abs_err'] <= CONTROL_ATOL and row['action_max_abs_err'] <= CONTROL_ATOL):
        raise RuntimeError(f'control pid quadrotor_3D: card and CPU differ: {row}')
    launches = _launches()
    emit('control', launches=launches)
    for m in PHYSICS.values():
        if launches[m['name']] <= 0:
            raise RuntimeError(f'the control path never launched {m["name"]}')
    # torch.profiler over one more cartpole solve: the device's busy share.
    ctrl = ctrls['cartpole']
    x0s = np.repeat(ctrl.env._nominal_init_state()[None], B_CONTROL, axis=0)
    wall, busy, n_kernels = _profiled(lambda: ctrl.solve_batch(x0s), cpu_activity=False)
    rows['trace'] = dict(window=f'one cartpole solve_batch, B={B_CONTROL}, under torch.profiler',
                         seconds=wall, device_busy_s=busy, kernels=n_kernels,
                         device_busy_share=busy / wall, card=smi)
    emit('control', part='trace', **rows['trace'])
    rows['checks'] = checks
    emit('control', part='done', seconds=time.perf_counter() - t_phase, card=smi)
    return launches, rows


def _grad_case(dev):
    """K1-K3's gradient through the kernel (``_PlainGrad``) against autograd
    through the plain twin on the same card inputs, and the demo's cost
    gradient through the card's env against the CPU's."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    from safe_control_gym_tpu_torch.utils.registration import make

    def grads(fn, args):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = fn(*leaves, N_SUB, DT)
        w = torch.linspace(0.5, 1.5, out.numel(), device=out.device).reshape(out.shape)
        (out * w).sum().backward()
        return [leaf.grad for leaf in leaves]

    rows = {}
    for system, meta in PHYSICS.items():
        kernel, plain = getattr(pk, meta['name']), getattr(pk, meta['name'] + '_plain')
        args = bs.physics_args(system, dev, B, seed=5)
        before = kernel.launches
        g_kernel = grads(kernel, args)
        launched = kernel.launches - before
        g_plain = grads(plain, args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(g_kernel, g_plain))
        scale = max(float(b.abs().max()) for b in g_plain)
        row = dict(kernel=meta['name'], B=B, n_substeps=N_SUB, launches=launched,
                   max_abs_err=err, grad_max=scale, rtol=GRAD_KERNEL_RTOL)
        rows[meta['id']] = row
        emit('mpc', part='gradient through the kernel against the plain twin', **row)
        if launched != 1 or not err <= GRAD_KERNEL_RTOL * scale:
            raise RuntimeError(f'{meta["id"]}\'s gradient differs from its twin\'s: {row}')

    actions = np.random.default_rng(0).uniform(-2.0, 2.0, (GRAD_T, 1)).astype(np.float32)

    def demo(device):
        env = make('cartpole', device=device, **GRAD_DEMO)
        w = torch.tensor([1.0, 0.1, 5.0, 0.1], device=env.device)
        a = torch.tensor(actions, device=env.device, requires_grad=True)
        est, _ = env.func.reset_batch(env.generator, 1)
        cost = torch.zeros((), device=env.device)
        for t in range(GRAD_T):
            est, _ = env.func.step(est, a[t][None])
            cost = cost + (w * est.state[0] ** 2).sum() + 0.001 * (a[t] ** 2).sum()
        cost.backward()
        return float(cost.detach()), a.grad.cpu().numpy()
    before = pk.cartpole_advance.launches
    c_cost, c_grad = demo(dev)
    launched = pk.cartpole_advance.launches - before
    h_cost, h_grad = demo('cpu')
    err = float(np.abs(c_grad - h_grad).max())
    row = dict(source='examples/differentiable_sim_demo.py', T=GRAD_T, n_substeps=50,
               k1_launches=launched, cost_card=c_cost, cost_cpu=h_cost,
               grad_max_abs_err=err, grad_max=float(np.abs(h_grad).max()), rtol=GRAD_RTOL)
    rows['demo'] = row
    emit('mpc', part='gradient of the demo cost, card env against CPU env', **row)
    if launched != GRAD_T or not (abs(c_cost - h_cost) <= GRAD_RTOL * abs(h_cost)
                                  and err <= GRAD_RTOL * row['grad_max']
                                  and row['grad_max'] > 0):
        raise RuntimeError(f'mpc: the card env\'s gradient differs from the CPU\'s: {row}')
    return rows


def _set_warm(ctrl, warm):
    ctrl.x_prev, ctrl.u_prev, ctrl._qp_warm = warm if warm is not None else (None,) * 3


def _mpc_run(ctrl, max_steps=None):
    """``ctrl.run(max_steps=max_steps)``, each step's inputs recorded: the
    observation, the info and the warm start the controller held, and its
    answer."""
    record = []
    select = ctrl.select_action

    def recording(obs, info=None):
        warm = None if ctrl.x_prev is None else (
            ctrl.x_prev.copy(), np.array(ctrl.u_prev), tuple(np.array(a) for a in ctrl._qp_warm))
        # GP-MPC's last transition, which online learning adds before a solve.
        online = (getattr(ctrl, 'last_obs', None), getattr(ctrl, 'last_action', None))
        action = select(obs, info)
        record.append(dict(obs=np.array(obs), info=info, warm=warm, action=np.array(action),
                           x=ctrl.x_prev.copy(), u=np.array(ctrl.u_prev), online=online))
        return action
    ctrl.select_action = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ctrl.run(max_steps=max_steps)
    wall = time.perf_counter() - t0
    del ctrl.select_action
    return res, record, wall


def _mpc_reeval(ctrl, obs, goal, X, U, dynamics=True):
    """The NLP residual (the horizon's dynamics defect under ``ctrl``'s
    dynamics, its initial-state error and constraint violation; without
    ``dynamics`` the last two) and the cost of B horizons X (B, T+1, nx) and
    U (B, T, nu) from the observations obs (B, nx) toward goal (nx, T+1), on
    ``ctrl``'s device: two (B,) arrays."""
    nx, nu, T = ctrl.model.nx, ctrl.model.nu, ctrl.T
    X = np.asarray(X, np.float32)
    U = np.asarray(U, np.float32).reshape(-1, T, nu)
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    n = X.shape[0]
    res = np.abs(X[:, 0] - obs[:, :nx]).max(axis=1)
    if dynamics:
        fx = torch.func.vmap(ctrl.dynamics_func)(Xt[:, :-1].reshape(-1, nx), Ut.reshape(-1, nu))
        res = np.maximum(res, np.abs(fx.numpy().reshape(n, T, nx) - X[:, 1:]).max(axis=(1, 2)))
    for fns, V in ((ctrl.state_constraints_sym, Xt), (ctrl.input_constraints_sym, Ut)):
        for f in fns:
            res = np.maximum(res, f(V.reshape(-1, V.shape[-1])).reshape(n, -1).amax(1).numpy())
    dx = X - goal.T
    du = U - ctrl.U_EQ
    Qs, Rs = getattr(ctrl, 'Q_stage', ctrl.Q), getattr(ctrl, 'R_stage', ctrl.R)
    Qterm = ctrl.P if ctrl.use_lqr_gain_and_terminal_cost else ctrl.Q
    cost = 0.5 * (np.einsum('bki,ij,bkj->b', dx[:, :-1], Qs, dx[:, :-1])
                  + np.einsum('bi,ij,bj->b', dx[:, -1], Qterm, dx[:, -1])
                  + np.einsum('bki,ij,bkj->b', du, Rs, du))
    return res, cost


def _mpc_gate(cpu, record):
    """Each recorded card step against ``cpu`` (the port's controller on the
    CPU) fed the same observation and warm start: action errors, and the
    card's and the CPU's answers re-evaluated on the CPU."""
    rows = []
    t0 = time.perf_counter()
    nu, T = cpu.model.nu, cpu.T
    for step in record:
        _set_warm(cpu, step['warm'])
        if hasattr(cpu, 'last_obs'):
            cpu.last_obs, cpu.last_action = step['online']
        action = cpu.select_action(step['obs'], step['info'])
        goal = cpu.get_references(cpu.extract_step(step['info']))
        obs = np.asarray(step['obs'], np.float32)[None]
        (res_card, res_cpu), (cost_card, cost_cpu) = _mpc_reeval(
            cpu, np.repeat(obs, 2, axis=0), goal, np.stack([step['x'].T, cpu.x_prev.T]),
            np.stack([np.reshape(u, (nu, T)).T for u in (step['u'], cpu.u_prev)]))
        bound = cpu.feas_tol * float(cpu._feas_scale(obs, goal)[0])
        rows.append((float(np.abs(action - step['action']).max()), res_card, res_cpu, bound,
                     abs(cost_card - cost_cpu) / max(1.0, abs(cost_cpu))))
    err, res_card, res_cpu, bound, cost_err = np.array(rows).T
    return dict(steps=len(rows), cpu_seconds=time.perf_counter() - t0,
                action_max_abs_err=float(err.max()),
                steps_within_atol_share=float((err <= MPC_ATOL).mean()),
                steps_beyond_atol=[int(k) for k in np.flatnonzero(err > MPC_ATOL)],
                reeval_residual_card_max=float(res_card.max()),
                reeval_residual_cpu_max=float(res_cpu.max()),
                reeval_residual_over_bound_max=float((res_card / bound).max()),
                reeval_cost_rel_err_max=float(cost_err.max()),
                ok=bool((err <= MPC_ATOL).mean() >= MPC_AGREE_SHARE
                        and (res_card <= bound).all() and (cost_err <= MPC_COST_RTOL).all()))


def _mpc_replay(env_id, task_cfg, dev, res):
    """The card loop's actions replayed through a card env made with
    ``pallas_physics=False`` (K1's or K2's plain twin in place of the kernel),
    from its reset: the largest difference of its states from the loop's."""
    from safe_control_gym_tpu_torch.utils.registration import make
    env = make(env_id, device=dev, pallas_physics=False, **task_cfg)
    env.reset()
    states = [np.array(env.state)]
    for action in res['action']:
        env.step(action)
        states.append(np.array(env.state))
    env.close()
    return float(np.abs(np.stack(states) - res['state']).max())


def mpc(dev, smi):
    """The slice's main path: make('linear_mpc' | 'mpc' | 'mpc_acados',
    partial(make, env, device='cuda', ...)) -> reset() -> run() through the
    entry points, K1 or K2 stepping every closed loop, and select_action_batch
    at B_MPC; see the module docstring."""
    from safe_control_gym_tpu_torch.controllers.mpc.mpc_utils import compute_state_rmse
    from safe_control_gym_tpu_torch.experiments.control_configs import control_config
    from safe_control_gym_tpu_torch.utils.registration import make
    t_phase = time.perf_counter()
    rows = {'gradient': _grad_case(dev),
            'checks': _bit_checks(dev, 'mpc', [('cartpole', 1, 50, 1.0 / 750),
                                               ('quadrotor', 1, 20, 1.0 / 1000)])}
    loops = [('linear_mpc', 'quadrotor_2D', 'track', 'quad2d_advance', MPC_QUAD_STEPS),
             ('mpc', 'cartpole', 'stab', 'cartpole_advance', MPC_CARTPOLE_STEPS),
             ('mpc_acados', 'cartpole', 'stab', 'cartpole_advance', MPC_CARTPOLE_STEPS)]
    ctrls = {}
    for algo, system, task, _, _ in loops:
        env_id, task_cfg, algo_cfg = control_config(algo, system, task)
        ctrls[algo] = [make(algo, functools.partial(make, env_id, device=d, **task_cfg),
                            **algo_cfg) for d in (dev, 'cpu')]
        for c in ctrls[algo]:
            c.reset()
    # One batch of two problems first: torch.func's first use is set-up.
    ctrls['mpc'][0].select_action_batch(np.zeros((2, 4), np.float32))
    _zero_launches()
    for algo, system, task, kname, max_steps in loops:
        env_id, task_cfg, _ = control_config(algo, system, task)
        card_ctrl, cpu = ctrls[algo]
        before = _launches()
        res, record, wall = _mpc_run(card_ctrl, max_steps)
        moved = _launches(before)
        steps = len(res['action'])
        state_rmse, total_rmse = compute_state_rmse(np.array(res['state_error']))
        gate = _mpc_gate(cpu, record)
        gate['replay_plain_max_abs_err'] = _mpc_replay(env_id, task_cfg, dev, res)
        qp_its = torch.stack(card_ctrl.qp_iterations).cpu().numpy().ravel().tolist()
        row = dict(algo=algo, system=system, task=task,
                   source=f'examples/mpc/config_overrides/{system}/{algo}_{system}_{task}.yaml',
                   horizon=card_ctrl.T, sqp_iters=card_ctrl.sqp_iters, n_z=card_ctrl._n_z,
                   m_rows=card_ctrl._m_rows, n_substeps=card_ctrl.env.PYB_STEPS_PER_CTRL,
                   steps=steps, episode_len=card_ctrl.env.CTRL_STEPS, wall_s=wall,
                   ms_per_step_median=1e3 * float(np.median(res['t_wall'])),
                   ms_per_step_mean=1e3 * float(np.mean(res['t_wall'])),
                   tracking_rmse=float(total_rmse), state_rmse=state_rmse.tolist(),
                   last_qp_admm_iterations=qp_its, launches=moved, gate=gate,
                   agree_share_gate=MPC_AGREE_SHARE, atol=MPC_ATOL, cost_rtol=MPC_COST_RTOL,
                   card=smi)
        # One more step under torch.profiler: kernels a control step and the
        # device's busy share.
        step = record[len(record) // 2]
        _set_warm(card_ctrl, step['warm'])
        p_wall, p_busy, p_kernels = _profiled(lambda: card_ctrl.select_action(step['obs'],
                                                                              step['info']))
        row['trace'] = dict(window='one select_action under torch.profiler', seconds=p_wall,
                            device_busy_s=p_busy, kernels=p_kernels,
                            device_busy_share=p_busy / p_wall)
        rows[algo] = row
        emit('mpc', part='closed loop, card against CPU', **row)
        _expect_launches(f'mpc {algo}', moved, kname, steps)
        if steps < 1 or not np.isfinite(total_rmse):
            raise RuntimeError(f'mpc {algo}: no finite closed loop: {steps} steps, rmse {total_rmse}')
        if not (gate['ok'] and gate['replay_plain_max_abs_err'] == 0.0):
            raise RuntimeError(f'mpc {algo}: the card\'s loop fails its gate: {gate}')
    launches = _launches()
    emit('mpc', launches=launches)
    for name in ('cartpole_advance', 'quad2d_advance'):
        if launches[name] <= 0:
            raise RuntimeError(f'the mpc path never launched {name}')
    # select_action_batch at B_MPC on the batched demo's problem.
    card_ctrl, cpu = (make('mpc', functools.partial(make, 'cartpole', device=d, **MPC_DEMO_TASK),
                           **MPC_DEMO_ALGO) for d in (dev, 'cpu'))
    card_ctrl.reset()
    cpu.reset()
    x0s = np.random.default_rng(0).uniform(-0.3, 0.3, (B_MPC, 4)).astype(np.float32)
    # A first call at the full batch: the timed call then finds the caching
    # allocator's blocks and the libraries' handles ready.
    card_ctrl.select_action_batch(x0s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    u, feasible = card_ctrl.select_action_batch(x0s)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    its = torch.stack(card_ctrl.qp_iterations).cpu().numpy()
    X_c, U_c = (t.cpu().numpy() for t in card_ctrl.batch_horizons)
    G = MPC_GATE_ROWS
    t0 = time.perf_counter()
    u_h, f_h = cpu.select_action_batch(x0s[:G])
    cpu_seconds = time.perf_counter() - t0
    err = np.abs(u[:G] - u_h).max(axis=1)
    # Every card answer, and the CPU's, re-evaluated on the CPU.
    goal = cpu.get_references(0)
    res_card, cost_card = _mpc_reeval(cpu, x0s, goal, X_c, U_c)
    res_cpu, cost_cpu = _mpc_reeval(cpu, x0s[:G], goal,
                                    *(t.numpy() for t in cpu.batch_horizons))
    bound = cpu.feas_tol * cpu._feas_scale(x0s, goal)
    cost_err = np.abs(cost_card[:G] - cost_cpu) / np.maximum(1.0, np.abs(cost_cpu))
    b_wall, b_busy, b_kernels = _profiled(lambda: card_ctrl.select_action_batch(x0s))
    row = dict(source='examples/mpc/batched_mpc_demo.py', B=B_MPC, horizon=card_ctrl.T,
               sqp_iters=card_ctrl.sqp_iters, n_z=card_ctrl._n_z, m_rows=card_ctrl._m_rows,
               seconds=seconds, solves_per_s=B_MPC / seconds,
               converged_share=float(feasible.mean()),
               admm_iterations_per_qp_max=its.max(axis=1).tolist(),
               admm_iterations_per_qp_mean=its.mean(axis=1).tolist(),
               peak_memory_bytes=int(peak), gate_rows=G, cpu_seconds=cpu_seconds,
               action_max_abs_err=float(err.max()),
               rows_within_atol_share=float((err <= MPC_ATOL).mean()),
               flags_equal=bool(np.array_equal(feasible[:G], f_h)),
               reeval_rows=B_MPC, reeval_feasible_rows_over_bound=int(
                   (res_card[feasible] > bound[feasible]).sum()),
               reeval_residual_over_bound_max=float((res_card / bound)[feasible].max()),
               reeval_residual_cpu_max=float(res_cpu.max()),
               reeval_cost_rel_err_max=float(cost_err.max()),
               agree_share_gate=MPC_AGREE_SHARE, atol=MPC_ATOL, cost_rtol=MPC_COST_RTOL,
               trace=dict(window=f'one select_action_batch, B={B_MPC}, under torch.profiler',
                          seconds=b_wall, device_busy_s=b_busy, kernels=b_kernels,
                          device_busy_share=b_busy / b_wall),
               card=smi)
    rows['batch'] = row
    emit('mpc', part='select_action_batch', **row)
    if not (np.isfinite(u).all() and row['flags_equal'] and feasible.any()
            and row['rows_within_atol_share'] >= MPC_AGREE_SHARE
            and row['reeval_feasible_rows_over_bound'] == 0
            and row['reeval_cost_rel_err_max'] <= MPC_COST_RTOL):
        raise RuntimeError(f'mpc select_action_batch: the card differs from the CPU: {row}')
    emit('mpc', part='done', seconds=time.perf_counter() - t_phase, card=smi)
    return launches, rows


def _expect_launches(label, moved, kname, n):
    if moved[kname] != n or sum(moved.values()) != n:
        raise RuntimeError(f'{label}: launches {moved}, expected {n} of {kname} alone')


def _gp_learn(card, kname):
    """``card.learn()`` on the card, its launches and its seconds (collection,
    training)."""
    before = _launches()
    t0 = time.perf_counter()
    card.learn()
    torch.cuda.synchronize()
    seconds = dict(card.learn_seconds, total_s=time.perf_counter() - t0)
    _expect_launches('gp_mpc learn', _launches(before), kname, card.num_samples)
    return seconds


def _gp_check(card, cpu):
    """The card's GPs against ``cpu``'s trained on the CPU on the card's data:
    log-parameters, and posterior mean and variance at GP_POINTS points
    (uniform over the data's box, numpy seed 0)."""
    t0 = time.perf_counter()
    cpu.train_gp(input_data=card.data_inputs, target_data=card.data_targets)
    cpu_s = time.perf_counter() - t0
    param_err = max(float((gc.params[k].cpu() - gh.params[k]).abs().max())
                    for gc, gh in zip(card.gaussian_process.gps, cpu.gaussian_process.gps)
                    for k in gc.params)
    lo, hi = card.data_inputs.min(axis=0), card.data_inputs.max(axis=0)
    pts = np.random.default_rng(0).uniform(lo, hi, (GP_POINTS, lo.size))
    (m_c, v_c), (m_h, v_h) = (c.gaussian_process.predict(pts) for c in (card, cpu))
    rel = lambda a, b: float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
    row = dict(n_data=int(card.data_inputs.shape[0]), adam_steps=card.optimization_iterations,
               log_param_max_abs_err=param_err, mean_max_rel_err=rel(m_c, m_h),
               var_max_rel_err=rel(v_c, v_h), points=GP_POINTS, atol=GP_ATOL,
               cpu_training_s=cpu_s)
    row['ok'] = bool(param_err <= GP_ATOL and row['mean_max_rel_err'] <= GP_ATOL
                     and row['var_max_rel_err'] <= GP_ATOL)
    return row


def _gp_tightening(card, record):
    """The card's fused tightening against its host reference along the
    card's own previous plans at up to four recorded steps."""
    steps = [s for s in record if s['warm'] is not None]
    errs, binds = [], []
    for step in steps[::max(1, len(steps) // 4)][:4]:
        _set_warm(card, step['warm'])
        hs, hu = (t[0].cpu().numpy() for t in card._constraint_tightening(0))
        host_binds = card._last_cap_binds
        X, U, has_prev = card._previous_plan()
        fs, fu, fb = card._tighten(X, U, card._tighten_params, has_prev)
        scale = max(float(np.abs(hs).max(initial=0.0)), float(np.abs(hu).max(initial=0.0)))
        errs.append(max(float(np.abs(fs[0].cpu().numpy() - hs).max(initial=0.0)),
                        float(np.abs(fu[0].cpu().numpy() - hu).max(initial=0.0)))
                    / max(scale, 1e-30))
        binds.append((int(fb[0]), host_binds))
    row = dict(steps=len(errs), max_rel_err=max(errs), rtol=GP_TIGHTEN_RTOL,
               binds_fused_host=binds)
    row['ok'] = bool(row['max_rel_err'] <= GP_TIGHTEN_RTOL and all(a == b for a, b in binds))
    return row


def _gp_loop(label, card, cpu, env_id, task_cfg, dev, kname, max_steps, smi, start=None):
    """One closed loop of ``card`` through ``run()``, gated against ``cpu``
    (the port's CPU controller) fed the card's GP data (its state ``start``
    before the loop, where online learning changes it, else after),
    observations, warm starts and last transitions; the replay through a
    pallas_physics=False card env; launches."""
    from safe_control_gym_tpu_torch.controllers.mpc.mpc_utils import compute_state_rmse
    before = _launches()
    res, record, wall = _mpc_run(card, max_steps)
    moved = _launches(before)
    steps = len(res['action'])
    _expect_launches(f'gp_mpc {label}', moved, kname, steps)
    state_rmse, total_rmse = compute_state_rmse(np.array(res['state_error']))
    cpu.load_state_dict(start if start is not None else card.state_dict())
    cpu.setup_results_dict()
    gate = _mpc_gate(cpu, record)
    gate['binds_equal'] = cpu.results_dict['tightening_cap_binds'] == res['tightening_cap_binds']
    gate['replay_plain_max_abs_err'] = _mpc_replay(env_id, task_cfg, dev, res)
    row = dict(loop=label, horizon=card.T, sqp_iters=card.sqp_iters, n_z=card._n_z,
               m_rows=card._m_rows, n_substeps=card.env.PYB_STEPS_PER_CTRL, steps=steps,
               episode_len=card.env.CTRL_STEPS, wall_s=wall,
               ms_per_step_median=1e3 * float(np.median(res['t_wall'])),
               ms_per_step_mean=1e3 * float(np.mean(res['t_wall'])),
               tracking_rmse=float(total_rmse), state_rmse=state_rmse.tolist(),
               capped_rows_per_step_max=int(max(res['tightening_cap_binds'])),
               launches=moved, gate=gate, agree_share_gate=MPC_AGREE_SHARE, atol=MPC_ATOL,
               card=smi)
    if steps < 1 or not np.isfinite(total_rmse):
        raise RuntimeError(f'gp_mpc {label}: no finite closed loop: {steps} steps')
    if not (gate['ok'] and gate['binds_equal'] and gate['replay_plain_max_abs_err'] == 0.0):
        raise RuntimeError(f'gp_mpc {label}: the card\'s loop fails its gate: {gate}')
    return row, record


def _gp_pair(dev, env_id, task_cfg, algo_cfg):
    from safe_control_gym_tpu_torch.utils.registration import make
    pair = [make('gp_mpc', functools.partial(make, env_id, device=d, **task_cfg), **algo_cfg)
            for d in (dev, 'cpu')]
    for c in pair:
        c.reset()
    return pair


def _gp_batch(dev, smi):
    """select_action_batch at B_GP on batched_gp_mpc_demo.py's problem, after
    learn() on the card."""
    card, cpu = _gp_pair(dev, 'cartpole', GP_DEMO_TASK, GP_DEMO_ALGO)
    learn = _gp_learn(card, 'cartpole_advance')
    cpu.load_state_dict(card.state_dict())
    x0s = np.random.default_rng(0).uniform(-0.3, 0.3, (B_GP, 4)).astype(np.float32)
    card.select_action_batch(x0s, passes=GP_PASSES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    u, feasible, binds = card.select_action_batch(x0s, passes=GP_PASSES)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    its = torch.stack(card.qp_iterations).cpu().numpy()
    X_c, U_c = (t.cpu().numpy() for t in card.batch_horizons)
    G = GP_GATE_ROWS
    t0 = time.perf_counter()
    u_h, f_h, b_h = cpu.select_action_batch(x0s[:G], passes=GP_PASSES)
    cpu_seconds = time.perf_counter() - t0
    # Every card answer re-evaluated on the CPU: its initial state and its
    # constraints under the feasibility bound, and its dynamics defect under
    # the GP dynamics. Two SQP iterations a pass from a cold start leave
    # defects near 1 on some problems, in the JAX package too, so a gate
    # row's defect is held to the CPU's own on the same problem (the largest
    # of its answers' where the card's answer is one of several).
    goal = cpu.get_references(0)
    res_card, _ = _mpc_reeval(cpu, x0s, goal, X_c, U_c, dynamics=False)
    defect_card, _ = _mpc_reeval(cpu, x0s, goal, X_c, U_c)
    defect_cpu, _ = _mpc_reeval(cpu, x0s[:G], goal, *(t.numpy() for t in cpu.batch_horizons))
    bound = cpu.feas_tol * cpu._feas_scale(x0s, goal)
    err = np.abs(u[:G] - u_h).max(axis=1)
    agree = []
    for i in np.flatnonzero(err > MPC_ATOL):
        answers, defects = [], []
        for x in (x0s[i:i + 1], _perturbed(x0s[i], GP_PERTURBED)):
            answers += list(cpu.select_action_batch(x, passes=GP_PASSES)[0])
            defects += list(_mpc_reeval(cpu, x, goal, *(t.numpy()
                                                         for t in cpu.batch_horizons))[0])
        defect_cpu[i] = max(defect_cpu[i], *defects)
        agree.append(dict(row=int(i), card_err=float(err[i]), card_defect=float(defect_card[i]),
                          **_agree(u[i], u_h[i], answers, atol=MPC_ATOL)))
    defect_over = defect_card[:G] - defect_cpu
    b_wall, b_busy, b_kernels = _profiled(
        lambda: card.select_action_batch(x0s, passes=GP_PASSES))
    row = dict(source='examples/mpc/batched_gp_mpc_demo.py', B=B_GP, passes=GP_PASSES,
               horizon=card.T, sqp_iters=card.sqp_iters, n_z=card._n_z, m_rows=card._m_rows,
               gp_points=int(card.data_inputs.shape[0]), learn=learn,
               learn_samples=card.num_samples, seconds=seconds,
               solves_per_s=B_GP / seconds, feasible_share=float(feasible.mean()),
               capped_share=float((binds > 0).mean()),
               admm_iterations_per_qp_max=its.max(axis=1).tolist(),
               peak_memory_bytes=int(peak), gate_rows=G, cpu_seconds=cpu_seconds,
               action_max_abs_err=float(err.max()),
               rows_within_atol_share=float((err <= MPC_ATOL).mean()), rows_beyond_atol=agree,
               rows_agree=all(a['ok'] for a in agree),
               flags_equal=bool(np.array_equal(feasible[:G], f_h)),
               binds_equal=bool(np.array_equal(binds[:G], b_h)), reeval_rows=B_GP,
               reeval_feasible_rows_over_bound=int((res_card[feasible] > bound[feasible]).sum()),
               reeval_residual_over_bound_max=float((res_card / bound)[feasible].max()),
               reeval_dynamics_defect_max=float(defect_card.max()),
               reeval_defect_under_bound_share=float((defect_card <= bound).mean()),
               gate_rows_defect_over_cpu_max=float(defect_over.max()),
               atol=MPC_ATOL,
               trace=dict(window=f'one select_action_batch, B={B_GP}, under torch.profiler',
                          seconds=b_wall, device_busy_s=b_busy, kernels=b_kernels,
                          device_busy_share=b_busy / b_wall),
               card=smi)
    if not (np.isfinite(u).all() and feasible.any() and row['rows_agree'] and row['flags_equal']
            and row['binds_equal'] and row['reeval_feasible_rows_over_bound'] == 0
            and row['gate_rows_defect_over_cpu_max'] <= MPC_ATOL):
        raise RuntimeError(f'gp_mpc select_action_batch: the card differs from the CPU: {row}')
    return row


def _gp_scenarios(dev, smi):
    """scenario_mpc_demo.py's multiple-model pick over N_SCENARIOS pole
    lengths for SCENARIO_STEPS steps of a card env: each step's candidates
    and flags against the port's CPU solve of the same state, the pick equal."""
    from safe_control_gym_tpu_torch.controllers.mpc.mpc import MPC
    from safe_control_gym_tpu_torch.envs.dynamics import (CartPoleParams, cartpole_dynamics,
                                                          rk4_step)
    from safe_control_gym_tpu_torch.utils.registration import make

    class ScenarioMPC(MPC):
        def dynamics_func_param(self, x, u, p):
            return rk4_step(cartpole_dynamics, x, u, self.dt, CartPoleParams(**p))

    card, cpu = (ScenarioMPC(functools.partial(make, 'cartpole', device=d, **SCENARIO_TASK),
                             **SCENARIO_MPC) for d in (dev, 'cpu'))
    card.reset()
    cpu.reset()
    lengths = np.random.default_rng(0).uniform(0.4, 1.0, N_SCENARIOS)
    lengths[0] = 0.5
    full = lambda v: np.full(N_SCENARIOS, v, np.float32)
    scen = dict(pole_length=lengths.astype(np.float32), pole_mass=full(0.1), cart_mass=full(1.0),
                gravity=full(9.8))
    params = CartPoleParams(**{k: torch.tensor(v) for k, v in scen.items()})
    env = make('cartpole', device=dev, **SCENARIO_TASK)
    obs, _ = env.reset()
    before = _launches()
    score, prev, rows, walls = np.zeros(N_SCENARIOS), None, [], []
    for _ in range(SCENARIO_STEPS):
        x = np.asarray(obs, np.float32)[:4]
        if prev is not None:
            pred = rk4_step(cartpole_dynamics, torch.tensor(prev[0]).expand(N_SCENARIOS, 4),
                            torch.tensor(prev[1]).expand(N_SCENARIOS, 1), card.dt, params)
            score = 0.9 * score + np.linalg.norm(pred.numpy() - x[None], axis=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u_c, f_c = card.select_action_scenarios(x, scen)
        walls.append(time.perf_counter() - t0)
        u_h, f_h = cpu.select_action_scenarios(x, scen)
        err = np.abs(u_c - u_h).max(axis=1)
        beyond = np.flatnonzero(err > MPC_ATOL)
        changed = [cpu.select_action_scenarios(v, scen)[0]
                   for v in _perturbed(x, GP_PERTURBED)] if beyond.size else []
        ok = [_agree(u_c[k], u_h[k], [c[k] for c in changed], atol=MPC_ATOL)['ok']
              for k in beyond]
        pick_c = int(np.argmin(np.where(f_c, score, np.inf)))
        pick_h = int(np.argmin(np.where(f_h, score, np.inf)))
        rows.append((float(err.max()), all(ok), bool(np.array_equal(f_c, f_h)),
                     pick_c == pick_h))
        prev = (x, np.atleast_1d(u_c[pick_c]).astype(np.float32))
        obs, _, _, _ = env.step(u_c[pick_c])
    moved = _launches(before)
    _expect_launches('gp_mpc scenarios', moved, 'cartpole_advance', SCENARIO_STEPS)
    err, agree, flags, picks = zip(*rows)
    row = dict(source='examples/mpc/scenario_mpc_demo.py', scenarios=N_SCENARIOS,
               steps=SCENARIO_STEPS, horizon=card.T, sqp_iters=card.sqp_iters,
               ms_per_step_median=1e3 * float(np.median(walls)),
               candidate_max_abs_err=max(err), candidates_agree=all(agree),
               flags_equal=all(flags), picks_equal=all(picks),
               identified_pole_length=float(lengths[int(np.argmin(score))]),
               launches=moved, atol=MPC_ATOL, card=smi)
    if not (row['candidates_agree'] and row['flags_equal'] and row['picks_equal']):
        raise RuntimeError(f'gp_mpc scenarios: the card differs from the CPU: {row}')
    return row


def gp_mpc(dev, smi):
    """The slice's main path: make('gp_mpc', partial(make, env, device='cuda',
    ...)) -> reset() -> learn() -> run(), K1 or K2 stepping every loop and
    every bootstrap sample; online learning, select_action_batch at B_GP and
    the scenario solve; see the module docstring."""
    from safe_control_gym_tpu_torch.experiments.control_configs import control_config
    t_phase = time.perf_counter()
    rows = {'checks': _bit_checks(dev, 'gp_mpc', [('cartpole', 1, 50, 1.0 / 750),
                                                  ('quadrotor', 1, 8, 1.0 / 240)])}
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out
    _zero_launches()
    loops = [('cartpole', *control_config('gp_mpc', 'cartpole', 'stab'), 'cartpole_advance',
              GP_CARTPOLE_STEPS),
             ('quadrotor_2D', 'quadrotor', GP_QUAD_TASK, GP_QUAD_ALGO, 'quad2d_advance',
              GP_QUAD_STEPS)]
    card_cartpole = None
    for system, env_id, task_cfg, algo_cfg, kname, max_steps in loops:
        t0 = time.perf_counter()
        card, cpu = _gp_pair(dev, env_id, task_cfg, algo_cfg)
        learn = _gp_learn(card, kname)
        gp_row = _gp_check(card, cpu)
        row, record = _gp_loop(system, card, cpu, env_id, task_cfg, dev, kname, max_steps, smi)
        row.update(learn=learn, learn_samples=card.num_samples, gp=gp_row,
                   tightening=_gp_tightening(card, record))
        if system == 'cartpole':
            # Two loop steps under torch.profiler: kernels a step, busy share.
            k = len(record) // 2
            _set_warm(card, record[k]['warm'])
            p_wall, p_busy, p_kernels = _profiled(lambda: [
                card.select_action(s['obs'], s['info']) for s in record[k:k + 2]])
            row['trace'] = dict(window='two select_action steps under torch.profiler',
                                seconds=p_wall, device_busy_s=p_busy, kernels=p_kernels,
                                kernels_per_step=p_kernels / 2, device_busy_share=p_busy / p_wall)
            card_cartpole = card
        rows[system] = row
        seconds[system] = time.perf_counter() - t0
        emit('gp_mpc', part='learn and closed loop, card against CPU', system=system, **row)
        if not (gp_row['ok'] and row['tightening']['ok']):
            raise RuntimeError(f'gp_mpc {system}: GP or tightening gate fails: {gp_row}, '
                               f'{row["tightening"]}')
    # Online learning: the cartpole's GPs trained on the same data with
    # GP_ONLINE_STEPS padded slots (train_gp pads with online_learning).
    t0 = time.perf_counter()
    env_id, task_cfg, algo_cfg = control_config('gp_mpc', 'cartpole', 'stab')
    card, cpu = _gp_pair(dev, env_id, task_cfg, dict(algo_cfg, online_learning=True,
                                                       online_buffer=GP_ONLINE_STEPS))
    card.train_gp(input_data=card_cartpole.data_inputs, target_data=card_cartpole.data_targets)
    row, _ = _gp_loop('cartpole online', card, cpu, env_id, task_cfg, dev, 'cartpole_advance',
                      GP_ONLINE_STEPS, smi, start=card.state_dict())
    ring = card.gaussian_process.gps[0]
    row['online_slots_filled'] = ring._ptr - ring._n0
    if row['online_slots_filled'] != row['steps'] - 1:
        raise RuntimeError(f'gp_mpc online: {row["online_slots_filled"]} slots filled in '
                           f'{row["steps"]} steps')
    rows['online'] = row
    seconds['online'] = time.perf_counter() - t0
    emit('gp_mpc', part='online learning, card against CPU', **row)
    rows['batch'] = part('batch', _gp_batch, dev, smi)
    emit('gp_mpc', part='select_action_batch', **rows['batch'])
    rows['scenarios'] = part('scenarios', _gp_scenarios, dev, smi)
    emit('gp_mpc', part='select_action_scenarios', **rows['scenarios'])
    launches = _launches()
    emit('gp_mpc', launches=launches, seconds_by_part=seconds)
    for name in ('cartpole_advance', 'quad2d_advance'):
        if launches[name] <= 0:
            raise RuntimeError(f'the gp_mpc path never launched {name}')
    emit('gp_mpc', part='done', seconds=time.perf_counter() - t_phase, card=smi)
    return launches, rows


class _Captured(Exception):
    """Raised by a filter's patched ``_solve`` once it has kept its inputs."""


# Config 5's certified loop runs the first 30 of its 250-step episode (50 in
# PR 14), for the script's time: every certification of the committed P is
# infeasible and takes the ladder's last rung, at every step alike.
CONFIG5_CERTIFIED_STEPS = 30
# The LQR loop certified by the cartpole's learned filter runs the first 45
# of its 90 steps, for the script's time.
CERT_LQR_STEPS = 45
# The CBF and CBF-NN loops run the first 100 steps of their episode (150
# in PR 14, 225 before), for the script's time.
CBF_STEPS = 100

# Phase safety's wall seconds by step, summed over the phase's parts.
_SAFETY_SECONDS = {}


@contextlib.contextmanager
def _timed(name):
    t0 = time.perf_counter()
    yield
    _SAFETY_SECONDS[name] = _SAFETY_SECONDS.get(name, 0.0) + time.perf_counter() - t0


def _filter_warm(sf):
    """What a filter's certify_action reads besides its arguments: MPSC's
    last plan, the QP's warm start and kinf (None for CBF, which keeps none)."""
    if not hasattr(sf, 'z_prev'):
        return None
    copy = lambda a: None if a is None else np.array(a)
    qp = None if sf._qp_warm is None else tuple(np.array(a) for a in sf._qp_warm)
    return copy(sf.z_prev), copy(sf.v_prev), qp, sf.kinf


def _set_filter_warm(sf, warm):
    if warm is not None:
        z_prev, v_prev, qp, sf.kinf = warm
        copy = lambda a: None if a is None else np.array(a)
        sf.z_prev, sf.v_prev = copy(z_prev), copy(v_prev)
        sf._qp_warm = None if qp is None else tuple(np.array(a) for a in qp)


def _recording_filter(sf, log):
    """Wrap ``sf.certify_action`` so that each call keeps its inputs, the
    filter's warm state, its answer and, for a feasible MPSC solve, the plan."""
    certify = sf.certify_action

    def recording(state, action, info=None):
        warm = _filter_warm(sf)
        t0 = time.perf_counter()
        certified, success = certify(state, action, info)
        feasible = bool(sf.results_dict['feasible'][-1])
        plan = None
        if feasible and hasattr(sf, 'z_prev'):
            plan = (np.array(sf.X_EQ), np.array(sf.z_prev), np.array(sf.v_prev))
        log.append(dict(state=np.array(state), action=np.array(action), info=info, warm=warm,
                        certified=np.array(certified), success=bool(success), feasible=feasible,
                        seconds=time.perf_counter() - t0, plan=plan))
        return certified, success
    sf.certify_action = recording


def _cpu_certify(cpu, log):
    """Each recorded step through ``cpu``'s certify_action from the step's
    warm state. The solves of all steps run first as one batch on the CPU:
    a first pass keeps the inputs certify_action hands ``_solve``, the batch
    solves them, and a second pass runs certify_action with ``_solve``
    answering from the batch. Returns the answers (certified, success,
    feasible) and the CPU seconds."""
    t0 = time.perf_counter()
    solve = cpu._solve
    inputs = []

    def capture(*args):
        inputs.append(args)
        raise _Captured

    def run_steps():
        out = []
        for step in log:
            _set_filter_warm(cpu, step['warm'])
            try:
                certified, success = cpu.certify_action(step['state'], step['action'],
                                                        step['info'])
            except _Captured:
                continue
            out.append((np.array(certified), bool(success), bool(cpu.results_dict['feasible'][-1])))
        return out
    cpu._solve = capture
    run_steps()
    outputs = solve(*(torch.cat(parts) for parts in zip(*inputs)))
    rows = iter(range(len(inputs)))

    def answer(*args):
        i = next(rows)
        return tuple(o[i:i + 1] for o in outputs)
    cpu._solve = answer
    answers = run_steps()
    del cpu._solve
    cpu.reset_before_run()
    return answers, time.perf_counter() - t0


def _mpsc_violation(sf, states, actions, plans):
    """The tube problem's constraint violation at each plan (X_EQ, z (nx,
    H+1), v (nu, H)) from its state and uncertified action, on the CPU: the
    dynamics defect under the filter's dynamics, the tightened state and
    input rows and the ellipse's inner box; and the true ellipse check.
    Returns the violations, the filter's feasibility bounds and the ellipse
    flags."""
    lam, Vp = np.linalg.eigh(np.asarray(sf.P, np.float64))
    hw = 1.0 / np.sqrt(sf.model.nx * np.clip(lam, 1e-12, None))
    A_s, b_s = sf.tightened_state_constraint.A, sf.tightened_state_constraint.b
    A_u, b_u = sf.tightened_input_constraint.A, sf.tightened_input_constraint.b
    viol, bounds, omega = [], [], []
    lo, hi = sf.env.physical_action_bounds
    for state, action, (xeq, z, v) in zip(states, actions, plans):
        Z, V = z.T, v.T
        with torch.no_grad():
            fz = torch.func.vmap(sf.dynamics_func)(torch.tensor(Z[:-1], dtype=torch.float32),
                                                  torch.tensor(V, dtype=torch.float32)).numpy()
        e = state[:sf.model.nx] - xeq - Z[0]
        viol.append(max(np.abs(Z[1:] - fz).max(),
                        np.max((Z[:-1] + xeq) @ A_s.T - b_s, initial=0.0),
                        np.max((V + sf.U_EQ) @ A_u.T - b_u, initial=0.0),
                        np.max(np.abs(Vp.T @ e) - hw, initial=0.0)))
        u_L = np.clip(np.asarray(action, np.float32), lo, hi)
        tol = sf.feas_tol * (max(1.0, float(np.abs(state).max()), float(np.abs(u_L).max()))
                             if sf.feas_tol_relative else 1.0)
        bounds.append(tol)
        omega.append(bool(sf._omega_ok(e[None], tol)[0]))
    return np.array(viol), np.array(bounds), np.array(omega)


def _cbf_violation(sf, states, us):
    """The CBF problem's violation at each answer u from its state x, on
    the CPU: the input rows, and the barrier row beyond the slack the filter
    allows. Returns each answer's violation over its bound (feas_tol for the
    input rows, slack_tolerance + feas_tol |b| for the barrier row)."""
    x = torch.tensor(np.asarray(states, np.float32))
    u = torch.tensor(np.asarray(us, np.float32)).reshape(x.shape[0], -1)
    with torch.no_grad():
        zeros = torch.zeros_like(u)
        a0 = torch.func.vmap(sf._lie)(x, zeros)
        b0 = torch.func.vmap(torch.func.jacfwd(sf._lie, argnums=1))(x, zeros)
        nn_a, nn_b = sf._nn_terms_batch(x.numpy())
        bt = (b0 + nn_a).numpy().astype(np.float64)
        rhs = (sf.slope * torch.func.vmap(sf.cbf)(x) + a0 + nn_b).numpy().astype(np.float64)
    u = u.numpy().astype(np.float64)
    barrier = np.clip(-(bt * u).sum(-1) - rhs, 0.0, None)
    inputs = np.clip(u @ sf.input_constraint.A.T - sf.input_constraint.b, 0.0, None).max(-1)
    slack = sf.slack_tolerance if sf.soft_constrained else 0.0
    return np.maximum(inputs / sf.feas_tol,
                      barrier / (slack + sf.feas_tol * np.maximum(1.0, np.abs(bt).max(-1))))


def _perturbed(state, n=SAFETY_PERTURBED):
    rng = np.random.default_rng(1)
    return np.stack([state * (1 + SAFETY_PERTURB * rng.standard_normal(state.shape))
                     for _ in range(n)]).astype(np.float32)


def _agree(card_u, ref, variants, atol=SAFETY_ATOL):
    """tests/test_torch_safety_filters.py's rule: the card's answer is the
    CPU's ``ref`` within ``atol``, or, where the CPU's own answer moves by
    more than ``atol`` among ``variants`` (its answers to the same problem
    alone and to the state changed by SAFETY_PERTURB), one of those within
    ``atol``. Returns the verdict, the CPU's spread and the card's distance
    to the nearest of the CPU's answers."""
    card_u, ref = (np.atleast_1d(np.asarray(a, np.float64)) for a in (card_u, ref))
    variants = [np.atleast_1d(np.asarray(a, np.float64)) for a in variants]
    spread = max(np.abs(a - ref).max() for a in variants)
    nearest = min(np.abs(card_u - a).max() for a in [ref, *variants])
    ok = np.abs(card_u - ref).max() <= atol or (spread > atol and nearest <= atol)
    return dict(ok=bool(ok), cpu_spread=float(spread), nearest_cpu_answer=float(nearest))


def _certified_gate(card, cpu, log):
    """A loop's recorded certifications against ``cpu`` (see the phase's
    constants): flags, the share of actions within SAFETY_ATOL, and every
    feasible card answer re-evaluated on the CPU (its violation over its
    bound, at most 1)."""
    answers, cpu_seconds = _cpu_certify(cpu, log)
    err = np.array([np.abs(np.asarray(a[0], np.float64) - step['certified']).max()
                    for a, step in zip(answers, log)])
    flags_equal = all(a[1] == step['success'] and a[2] == step['feasible']
                      for a, step in zip(answers, log))
    feasible = [step for step in log if step['feasible']]
    if not feasible:
        over = np.zeros(0)
        omega_ok = True
    elif hasattr(cpu, 'P'):
        viol, bound, omega = _mpsc_violation(cpu, [s['state'] for s in feasible],
                                             [s['action'] for s in feasible],
                                             [s['plan'] for s in feasible])
        over, omega_ok = viol / bound, bool(omega.all())
    else:
        over = _cbf_violation(cpu, [s['state'] for s in feasible],
                              [s['certified'] for s in feasible])
        omega_ok = True
    return dict(steps=len(log), cpu_seconds=cpu_seconds, flags_equal=flags_equal,
                action_max_abs_err=float(err.max()),
                steps_within_atol_share=float((err <= SAFETY_ATOL).mean()),
                agree_share_gate=SAFETY_AGREE_SHARE,
                steps_beyond_atol=[int(k) for k in np.flatnonzero(err > SAFETY_ATOL)],
                reeval_feasible_steps=len(feasible),
                reeval_violation_over_bound_max=float(over.max()) if over.size else 0.0,
                reeval_omega_ok=omega_ok,
                ok=bool(flags_equal and (err <= SAFETY_ATOL).mean() >= SAFETY_AGREE_SHARE
                        and (over <= 1.0).all() and omega_ok))


def _replay_states(env_id, task_cfg, dev, data):
    """A run's actions replayed through a card env made with
    ``pallas_physics=False`` from the same reset: the largest difference of
    its states from the run's."""
    from safe_control_gym_tpu_torch.utils.registration import make
    env = make(env_id, device=dev, pallas_physics=False, **task_cfg)
    env.reset()
    env.reset()       # BaseExperiment resets twice: in reset() and for the run
    states = [np.array(env.state)]
    for action in data['action'][0]:
        env.step(action)
        states.append(np.array(env.state))
    env.close()
    return float(np.abs(np.stack(states) - data['state'][0]).max())


def _evaluate(env_func, ctrl, sf=None, log=None, n_steps=None):
    """One episode (or its first ``n_steps``, which must be fewer than the
    episode's: run_evaluation counts steps from the last reset) through
    ``BaseExperiment.run_evaluation``; with ``log``, the filter's
    certifications recorded. Returns the data, the metrics, the wall seconds
    and the launches of each kernel."""
    from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
    if log is not None:
        _recording_filter(sf, log)
    exp = BaseExperiment(env=env_func(), ctrl=ctrl, safety_filter=sf)
    before = _launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, metrics = exp.run_evaluation(n_episodes=None if n_steps else 1, n_steps=n_steps,
                                       verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = _launches(before)
    exp.close()
    if log is not None:
        del sf.certify_action
    return data, metrics, wall, moved


def _checked_loop(row, card, cpu, log, env_id, task, dev, data, env_func=None, ctrl=None):
    """A certified loop's gate against the CPU and its replay through the
    plain twin, and with ``env_func`` a profiler window of two of its steps,
    into ``row``."""
    with _timed('cpu gates'):
        row['gate'] = _certified_gate(card, cpu, log)
    with _timed('replays'):
        row['replay_plain_max_abs_err'] = _replay_states(env_id, task, dev, data)
    if env_func is not None:
        with _timed('traces'):
            row['trace'] = _trace_steps(env_func, ctrl, card)


def _run_row(data, metrics, wall, moved, log=None, horizon=None):
    steps = int(metrics['average_length'])
    row = dict(steps=steps, wall_s=wall, ms_per_step=1e3 * wall / steps,
               average_constraint_violation=float(metrics['average_constraint_violation']),
               average_return=float(metrics['average_return']),
               average_rmse=float(metrics['average_rmse']), launches=moved)
    if log is not None:
        sfd = data['safety_filter_data']
        feasible = np.asarray(sfd['feasible'][0], bool)
        row.update(feasible_share=float(feasible.mean()),
                   success_share=float(np.mean([s['success'] for s in log])),
                   mean_correction=float(np.mean(sfd['correction'][0])),
                   ms_per_certification=1e3 * float(np.mean([s['seconds'] for s in log])))
        if 'kinf' in sfd:
            # kinf 0: certified; 1..H-1: the last plan replayed; >= H: LQR.
            kinf, H = np.asarray(sfd['kinf'][0], int), horizon
            row['kinf_histogram'] = {'0': int((kinf == 0).sum()),
                                     '1..H-1': int(((kinf > 0) & (kinf < H)).sum()),
                                     '>=H': int((kinf >= H).sum())}
    return row


def _trace_steps(env_func, ctrl, sf, n_steps=2):
    """``n_steps`` certified steps through run_evaluation under
    torch.profiler (the card's activity alone: a step is tens of thousands
    of kernels): seconds, the device's busy seconds and share, kernels a
    step."""
    from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
    exp = BaseExperiment(env=env_func(), ctrl=ctrl, safety_filter=sf)
    wall, busy, kernels = _profiled(lambda: exp.run_evaluation(n_steps=n_steps, verbose=False),
                                    cpu_activity=False)
    exp.close()
    return dict(window=f'run_evaluation(n_steps={n_steps}) under torch.profiler', seconds=wall,
                device_busy_s=busy, device_busy_share=busy / wall,
                kernels_per_step=kernels / n_steps)


def _check_run(label, row, kernel, gate=None, replay=None):
    if row['launches'][kernel] != row['steps'] or sum(row['launches'].values()) != row['steps']:
        raise RuntimeError(f'safety {label}: launches {row["launches"]}, expected '
                           f'{row["steps"]} of {kernel} alone')
    if not np.isfinite(row['average_return']):
        raise RuntimeError(f'safety {label}: no finite return: {row}')
    if gate is not None and not gate['ok']:
        raise RuntimeError(f'safety {label}: the card\'s certifications fail their gate: {gate}')
    if replay is not None and replay != 0.0:
        raise RuntimeError(f'safety {label}: the replay through the plain twin differs: {replay}')


def _config5(dev, smi):
    """BASELINE.json's fifth config: SAC on the 2D quad (the committed
    model), uncertified, then certified by linear MPSC loaded from the
    committed P, through BaseExperiment (examples/mpsc/mpsc_experiment.py's
    shaping of the env and the filter's env)."""
    from safe_control_gym_tpu_torch.experiments.control_configs import safety_config
    from safe_control_gym_tpu_torch.utils.registration import make
    env_id, task, algo_cfg, sfs = safety_config('mpsc', 'quadrotor_2D', 'stab', 'sac')
    task = dict(task, randomized_init=False, cost='rl_reward')
    sf_task = dict(task, normalized_rl_action_space=False, cost='quadratic')
    env_func = functools.partial(make, env_id, device=dev, **task)
    with _timed('set-up'):
        ctrl = make('sac', env_func, training=False, **algo_cfg)
        ctrl.load(os.path.join(ROOT, 'examples/mpsc/models/sac_model_quadrotor_2D_stab.pt'))
        card, cpu = (make('linear_mpsc', functools.partial(make, env_id, device=d, **sf_task),
                          **sfs['linear_mpsc']) for d in (dev, 'cpu'))
        for sf in (card, cpu):
            sf.load(os.path.join(ROOT, 'examples/mpsc/models/linear_mpsc_quadrotor_2D.pkl'))
    with _timed('loops'):
        rows = {'uncertified': _run_row(*_evaluate(env_func, ctrl))}
        ctrl.reset()
        log = []
        data, metrics, wall, moved = _evaluate(env_func, ctrl, card, log,
                                               n_steps=CONFIG5_CERTIFIED_STEPS)
    row = _run_row(data, metrics, wall, moved, log, card.horizon)
    row['qp_admm_iterations_last_step'] = torch.stack(card.qp_iterations).cpu().numpy().ravel().tolist()
    _checked_loop(row, card, cpu, log, env_id, task, dev, data, env_func, ctrl)
    with _timed('capture a/b'):
        row['ms_per_certification_by_capture'] = _capture_ab(card, log[0])
    rows['certified'] = row
    for name, r in rows.items():
        emit('safety', part=f'config 5 (SAC + linear MPSC, quadrotor_2D stab), {name}',
             source='examples/mpsc/config_overrides/quadrotor_2D/quadrotor_2D_stab.yaml, '
                    'sac_quadrotor_2D.yaml, linear_mpsc_quadrotor_2D.yaml',
             horizon=card.horizon, sqp_iters=card.sqp_iters, qp_iters=card.qp_iters,
             n_z=card._n_z, m_rows=card._m_rows, n_substeps=card.env.PYB_STEPS_PER_CTRL,
             card=smi, **r)
    _check_run('config 5 uncertified', rows['uncertified'], 'quad2d_advance')
    _check_run('config 5 certified', row, 'quad2d_advance', row['gate'],
               row['replay_plain_max_abs_err'])
    return rows


def _capture_ab(sf, step):
    """ms of the recorded certification ``step`` with ops/qp.py's stages
    replayed as CUDA graphs (the filter's call) and launched op by op (the
    filter module's ``admm_qp`` swapped for one with ``capture=False``), in
    turns (launched, captured, captured, launched)."""
    from safe_control_gym_tpu_torch.safety_filters.mpsc import linear_mpsc
    captured = linear_mpsc.admm_qp
    launched = lambda *args, **kw: captured(*args, **dict(kw, capture=False))
    times = {False: [], True: []}
    try:
        for capture in (False, True, True, False):
            linear_mpsc.admm_qp = captured if capture else launched
            _set_filter_warm(sf, step['warm'])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sf.certify_action(step['state'], step['action'], step['info'])
            torch.cuda.synchronize()
            times[capture].append(1e3 * (time.perf_counter() - t0))
    finally:
        linear_mpsc.admm_qp = captured
    sf.reset_before_run()
    return {'launched': float(np.mean(times[False])), 'captured': float(np.mean(times[True]))}


def _rpi_checks(card, cpu_logdets):
    """The card's P against every sampled block (float64) and the CPU's log
    det on the same residuals."""
    from safe_control_gym_tpu_torch.safety_filters.mpsc import mpsc_utils
    A_cl = card.discrete_dfdx + card.discrete_dfdu @ card.lqr_gain
    W = np.asarray(card.residuals, np.float64).T
    D = mpsc_utils._preconditioner(np.asarray(A_cl, np.float64), W)
    P_s = np.asarray(card.P, np.float64) / np.outer(D, D)
    A_s = (D[:, None] * A_cl) / D[None, :]
    max_eig = float(mpsc_utils._max_lmi_eigs(
        torch.tensor(P_s), torch.tensor(A_s), torch.tensor(W * D[None, :]), float(card.tau)).max())
    ld = float(np.linalg.slogdet(card.P)[1])
    spread = max(cpu_logdets) - min(cpu_logdets)
    nearest = min(abs(ld - x) for x in cpu_logdets)
    return dict(max_block_eig_f64=max_eig, eig_tol=RPI_EIG_TOL, logdet_card=ld,
                logdet_cpu=cpu_logdets[0], logdet_cpu_perturbed=cpu_logdets[1:],
                logdet_rel_err=abs(ld - cpu_logdets[0]) / abs(cpu_logdets[0]),
                logdet_nearest_cpu_err=nearest, cpu_spread=spread, rtol=RPI_LOGDET_RTOL,
                ok=bool(max_eig <= RPI_EIG_TOL and nearest
                        <= max(RPI_LOGDET_RTOL * abs(cpu_logdets[0]), spread)))


def _cpu_rpi_logdet(A_cl, w, tau, k):
    """log det of the CPU's RPI set on the residuals w (k = 0) or on the
    k-th copy changed by RPI_PERTURB relative (numpy seed 1); run in a worker
    process, one a set."""
    from safe_control_gym_tpu_torch.safety_filters.mpsc.mpsc_utils import compute_RPI_set
    torch.set_num_threads(1)
    rng = np.random.default_rng(1)
    for _ in range(k):
        wk = w * (1 + RPI_PERTURB * rng.standard_normal(w.shape))
    return float(np.linalg.slogdet(compute_RPI_set(A_cl, w if k == 0 else wk, tau,
                                                   device='cpu'))[1])


def _cartpole_learn(dev, smi, pool):
    """learn() on the card on the batched demo's cartpole; the CPU's RPI sets
    on the card's residuals submitted to ``pool``. Returns the card's filter,
    learn()'s row and the CPU's future."""
    from safe_control_gym_tpu_torch.utils.registration import make
    with _timed('set-up'):
        card = make('linear_mpsc', functools.partial(make, 'cartpole', device=dev,
                                                     **CERT_DEMO_TASK), **CERT_DEMO_SF)
    before = _launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _timed('learn'):
        card.learn()
        torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    learn_launches = _launches(before)
    learn = dict(seconds=learn_s, split=card.learn_seconds, n_samples=card.n_samples,
                 launches=learn_launches, P=np.asarray(card.P).tolist())
    emit('safety', part='linear MPSC learn() on the card', source='examples/mpsc/'
         'batched_certification_demo.py (tests/test_safety_filters.py\'s config)', card=smi,
         **learn)
    if learn_launches['cartpole_advance'] != card.n_samples:
        raise RuntimeError(f'safety learn(): {learn_launches}')
    A_cl = card.discrete_dfdx + card.discrete_dfdu @ card.lqr_gain
    return card, learn, [pool.submit(_cpu_rpi_logdet, A_cl, card.residuals, card.tau, k)
                         for k in range(3)]


def _cartpole_rpi(card, learn, cpu_rpi, smi):
    """The learned RPI set against the CPU's (``cpu_rpi``'s log dets)."""
    with _timed('waiting for the cpu rpi sets'):
        logdets = [f.result() for f in cpu_rpi]
    rpi = _rpi_checks(card, logdets)
    emit('safety', part='the learned RPI set: its blocks (float64) and the CPU\'s log det',
         card=smi, **rpi)
    if not rpi['ok']:
        raise RuntimeError(f'safety learn(): {rpi}')
    return dict(learn, rpi=rpi)


def _cartpole_certified(card, dev, smi):
    """certify_action_batch at B_SAFETY on the batched demo's states and
    actions, and an LQR loop certified by the card's learned filter, both
    against the port's CPU filter loaded with the card's P."""
    from safe_control_gym_tpu_torch.utils.registration import make
    with _timed('set-up'):
        cpu = make('linear_mpsc', functools.partial(make, 'cartpole', device='cpu',
                                                    **CERT_DEMO_TASK), **CERT_DEMO_SF)
        with tempfile.TemporaryDirectory() as tmp:
            card.save(os.path.join(tmp, 'mpsc.pkl'))
            cpu.load(os.path.join(tmp, 'mpsc.pkl'))
    rows = {}
    # certify_action_batch at B_SAFETY on the demo's states and actions.
    rng = np.random.default_rng(0)
    states = rng.normal(0, 0.3, (B_SAFETY, 4)).astype(np.float32)
    actions = rng.uniform(-4, 4, (B_SAFETY, 1)).astype(np.float32)
    rows['batch'] = _batch_row(card, cpu, states, actions,
                               'examples/mpsc/batched_certification_demo.py', smi)
    # An LQR loop certified by the learned filter (tests/test_safety_filters.py's).
    env_func = functools.partial(make, 'cartpole', device=dev, **CERT_DEMO_TASK)
    ctrl = make('lqr', env_func, q_lqr=[1], r_lqr=[0.1])
    log = []
    with _timed('loops'):
        data, metrics, wall, moved = _evaluate(env_func, ctrl, card, log, CERT_LQR_STEPS)
    row = _run_row(data, metrics, wall, moved, log, card.horizon)
    _checked_loop(row, card, cpu, log, 'cartpole', CERT_DEMO_TASK, dev, data)
    rows['lqr loop'] = row
    emit('safety', part='linear MPSC on the cartpole, LQR certified by the learned filter',
         horizon=card.horizon, n_z=card._n_z, m_rows=card._m_rows, card=smi, **row)
    _check_run('cartpole LQR + MPSC', row, 'cartpole_advance', row['gate'],
               row['replay_plain_max_abs_err'])
    return rows


def _batch_row(card, cpu, states, actions, source, smi):
    """certify_action_batch of B rows on the card: time, memory, a profiler
    window; every answer re-evaluated on the CPU; the first rows against the
    CPU's batch."""
    # A first call at the full batch captures ops/qp.py's graphs for its
    # shapes (and sets up the allocator's blocks), outside the timed call.
    with _timed('batches: first call'):
        card.certify_action_batch(states, actions)
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    u, feasible = card.certify_action_batch(states, actions)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    G = SAFETY_GATE_ROWS
    t0 = time.perf_counter()
    with _timed('cpu gates'):
        u_h, f_h = cpu.certify_action_batch(states[:G], actions[:G])
    cpu_seconds = time.perf_counter() - t0
    err = np.abs(u[:G] - u_h).max(axis=1)
    beyond = np.flatnonzero(err > SAFETY_ATOL)
    agree = []
    t0 = time.perf_counter()
    for i in beyond:
        alone = cpu.certify_action_batch(states[i:i + 1], actions[i:i + 1])[0][0]
        changed = _perturbed(states[i])
        changed = cpu.certify_action_batch(changed, np.repeat(actions[i][None], len(changed),
                                                              axis=0))[0]
        agree.append(dict(row=int(i), card_err=float(err[i]), **_agree(u[i], u_h[i],
                                                                       [alone, *changed])))
    _SAFETY_SECONDS['cpu gates'] += time.perf_counter() - t0
    B_rows = states.shape[0]
    row = dict(source=source, B=B_rows, seconds=seconds, certifications_per_s=B_rows / seconds,
               feasible_share=float(feasible.mean()), peak_memory_bytes=int(peak), gate_rows=G,
               cpu_seconds=cpu_seconds, action_max_abs_err=float(err.max()),
               rows_within_atol_share=float((err <= SAFETY_ATOL).mean()),
               rows_beyond_atol=agree, flags_equal=bool(np.array_equal(feasible[:G], f_h)))
    if hasattr(card, 'P'):
        with _timed('traces'):
            b_wall, b_busy, b_kernels = _profiled(
                lambda: card.certify_action_batch(states, actions), cpu_activity=False)
        row['trace'] = dict(window=f'one certify_action_batch, B={B_rows}, under '
                                   'torch.profiler', seconds=b_wall, device_busy_s=b_busy,
                            kernels=b_kernels, device_busy_share=b_busy / b_wall)
        Z, V = (t.cpu().numpy() for t in card.batch_plans)
        xeqs = np.stack([cpu._xeq_for(s) for s in states])
        plans = [(xeqs[i], Z[i].T, V[i].T) for i in np.flatnonzero(feasible)]
        viol, bound, omega = _mpsc_violation(cpu, states[feasible], actions[feasible], plans)
        its = torch.stack(card.qp_iterations).cpu().numpy()
        row.update(horizon=card.horizon, sqp_iters=card.sqp_iters, n_z=card._n_z,
                   m_rows=card._m_rows, admm_iterations_per_qp_max=its.max(axis=1).tolist(),
                   admm_iterations_per_qp_mean=its.mean(axis=1).tolist(),
                   reeval_omega_ok=bool(omega.all()))
        over = viol / bound
    else:
        over = _cbf_violation(cpu, states[feasible], u[feasible])
        row['reeval_omega_ok'] = True
    row.update(reeval_rows=int(feasible.sum()),
               reeval_violation_over_bound_max=float(over.max()) if over.size else 0.0)
    row['card'] = smi
    emit('safety', part=f'{type(card).__name__}.certify_action_batch', **row)
    if not (np.isfinite(u).all() and row['flags_equal'] and feasible.any()
            and all(a['ok'] for a in agree)
            and (over <= 1.0).all() and row['reeval_omega_ok']):
        raise RuntimeError(f'safety {type(card).__name__} batch: the card differs from the '
                           f'CPU: {row}')
    return row


def _cbf_family(dev, smi):
    """CBF and CBF-NN (the committed model) on the cbf example's cartpole
    (50 Hz, one substep) with LQR: a certified episode through
    BaseExperiment each, and certify_action_batch at B_SAFETY."""
    from safe_control_gym_tpu_torch.experiments.control_configs import safety_config
    from safe_control_gym_tpu_torch.utils.registration import make
    env_id, task, algo_cfg, sfs = safety_config('cbf', 'cartpole', 'stab', 'lqr')
    rng = np.random.default_rng(0)
    states = rng.normal(0, 0.3, (B_SAFETY, 4)).astype(np.float32)
    actions = rng.uniform(-4, 4, (B_SAFETY, 1)).astype(np.float32)
    rows = {}
    for name in ('cbf', 'cbf_nn'):
        env_func = functools.partial(make, env_id, device=dev, **task)
        with _timed('set-up'):
            card, cpu = (make(name, functools.partial(make, env_id, device=d, **task),
                              **sfs[name]) for d in (dev, 'cpu'))
            if name == 'cbf_nn':
                for sf in (card, cpu):
                    sf.load(os.path.join(ROOT, 'examples/cbf/models/cbf_nn_cartpole.pt'))
            ctrl = make('lqr', env_func, **algo_cfg)
        log = []
        with _timed('loops'):
            data, metrics, wall, moved = _evaluate(env_func, ctrl, card, log, CBF_STEPS)
        row = _run_row(data, metrics, wall, moved, log)
        _checked_loop(row, card, cpu, log, env_id, task, dev, data)
        emit('safety', part=f'{name} on the cartpole, LQR certified',
             source=f'examples/cbf/config_overrides/cartpole/{name}_cartpole_stab.yaml',
             n_substeps=card.env.PYB_STEPS_PER_CTRL, card=smi, **row)
        _check_run(f'{name} loop', row, 'cartpole_advance', row['gate'],
                   row['replay_plain_max_abs_err'])
        rows[name] = {'loop': row, 'batch': _batch_row(
            card, cpu, states, actions,
            f'examples/cbf/config_overrides/cartpole/ ({name}); batched demo states', smi)}
    return rows


def safety(dev, smi):
    """The slice's main path: the safety filters through
    make('linear_mpsc' | 'cbf' | 'cbf_nn', partial(make, env, device='cuda',
    ...)) and BaseExperiment(..., safety_filter=...).run_evaluation, K1 or K2
    stepping every loop; see the module docstring."""
    t_phase = time.perf_counter()
    rows = {'checks': _bit_checks(dev, 'safety', [('cartpole', 1, 1, 1.0 / 50),
                                                  ('cartpole', 1, 50, 1.0 / 750),
                                                  ('quadrotor', 1, 20, 1.0 / 1000)])}
    _zero_launches()
    seconds = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out
    # learn() first: the CPU's RPI sets on its residuals run in a worker
    # process while the card goes on with the other parts.
    pool = ProcessPoolExecutor(max_workers=3, mp_context=multiprocessing.get_context('spawn'))
    try:
        card, learn, cpu_rpi = part('cartpole_mpsc', _cartpole_learn, dev, smi, pool)
        rows['config5'] = part('config5', _config5, dev, smi)
        rows['cartpole_mpsc'] = part('cartpole_mpsc', _cartpole_certified, card, dev, smi)
        rows['cbf'] = part('cbf', _cbf_family, dev, smi)
        rows['cartpole_mpsc']['learn'] = part('cartpole_mpsc', _cartpole_rpi, card, learn,
                                              cpu_rpi, smi)
    finally:
        pool.shutdown()
    launches = _launches()
    emit('safety', launches=launches, seconds_by_part=seconds,
         seconds_by_step=dict(_SAFETY_SECONDS))
    for name in ('cartpole_advance', 'quad2d_advance'):
        if launches[name] <= 0:
            raise RuntimeError(f'the safety path never launched {name}')
    emit('safety', part='done', seconds=time.perf_counter() - t_phase, card=smi)
    return launches, rows


def _off_policy_ctrl(algo, dev, out_dir, env_id, task_cfg, algo_cfg):
    from safe_control_gym_tpu_torch.utils.registration import make
    return make(algo, functools.partial(make, env_id, device=dev, **task_cfg), training=True,
                output_dir=os.path.join(out_dir, algo), seed=0, checkpoint_path='',
                **algo_cfg)


def _off_policy_train(label, ctrl, kname, smi):
    """reset + learn of an off-policy learner on the card, every launch
    counter set to 0 before and read after; the row, gated on finite losses,
    total_steps and the kernel's launches (one a collect step)."""
    _zero_launches()
    wall = _train(ctrl)
    launches = _launches()
    steps = ctrl.total_steps // ctrl.N
    per_iter = ctrl.N * ctrl.steps_per_iter
    trained = ctrl.total_steps // per_iter - -(-int(ctrl.warm_up_steps) // per_iter)
    last = ctrl.last_results
    row = dict(envs=ctrl.N, steps_per_iter=ctrl.steps_per_iter,
               train_interval=int(ctrl.train_interval),
               train_batch_size=int(ctrl.train_batch_size), hidden=int(ctrl.hidden_dim),
               warm_up_steps=int(ctrl.warm_up_steps), total_steps=ctrl.total_steps,
               max_env_steps=int(ctrl.max_env_steps), wall_s=wall,
               collect_s=ctrl.train_seconds['collect'], update_s=ctrl.train_seconds['update'],
               updates=trained * int(ctrl.train_interval),
               last_iteration={k: last[k] for k in ('mean_reward', 'policy_loss', 'critic_loss')},
               launches=launches, card=smi)
    emit('off_policy', part=label, **row)
    if not all(np.isfinite(row['last_iteration'][k]) for k in ('policy_loss', 'critic_loss')):
        raise RuntimeError(f'off_policy {label}: a loss is not finite: {last}')
    if ctrl.total_steps < int(ctrl.max_env_steps):
        raise RuntimeError(f'off_policy {label} stopped at {ctrl.total_steps} steps')
    _expect_launches(f'off_policy {label}', launches, kname, steps)
    return row


def _update_pair(agent_cls, ctrl, kw):
    """One update of ``ctrl``'s agent on the card and of a CPU copy, on one
    batch from the card's ring and one set of normals; returns the largest
    difference over every array of the two state dicts."""
    from safe_control_gym_tpu_torch.controllers.off_policy_utils import replay_sample
    from safe_control_gym_tpu_torch.math.optim import tree_leaves
    batch = replay_sample(ctrl.buffer, ctrl.gen, int(ctrl.train_batch_size))
    cpu = agent_cls(ctrl.env.observation_space, ctrl.env.action_space, device='cpu', **kw)
    cpu.load_state_dict(ctrl.agent.state_dict())
    g = torch.Generator().manual_seed(0)
    act_dim = ctrl.env.action_space.shape[0]
    noise = [torch.randn((int(ctrl.train_batch_size), act_dim), generator=g) for _ in range(2)]
    card_losses = ctrl.agent.update(batch, noise=[n.to(ctrl.device) for n in noise])
    cpu_losses = cpu.update({k: v.cpu() for k, v in batch.items()}, noise=noise)
    errs = [float(np.abs(a - b).max()) for a, b in zip(tree_leaves(ctrl.agent.state_dict()),
                                                         tree_leaves(cpu.state_dict()))]
    return dict(max_abs_err=max(errs), arrays=len(errs), rows=int(ctrl.train_batch_size),
                losses_card=card_losses.cpu().tolist(), losses_cpu=cpu_losses.tolist(),
                atol=OFF_POLICY_UPDATE_ATOL)


def _compare_rollouts(k, p):
    """A kernel rollout's outputs against its plain version's: the state and
    reward-sum errors, the envs whose counts differ, and whether they pass
    the policy gate (1e-4; rewards 1e-4 + 1e-4 |r|; no count differs)."""
    state_err = float((k['state'] - p['state']).abs().max())
    rew_err = float((k['reward_sum'] - p['reward_sum']).abs().max())
    flips = {key: int((k[key] != p[key]).sum())
             for key in ('done_count', 'ctrl_step', 'violation_count')}
    ok = (state_err <= 1e-4 and bool(((k['reward_sum'] - p['reward_sum']).abs()
                                       <= 1e-4 + 1e-4 * p['reward_sum'].abs()).all())
          and not any(flips.values()))
    return state_err, rew_err, flips, ok


def _trained_actor_k4(label, ctrl, smi):
    """``ctrl``'s trained actor through ``evaluate_fused`` at B (K4's policy
    mode, path and launches asserted), then K4 on the launch inputs the
    closed loop builds against its plain version (1e-4)."""
    from safe_control_gym_tpu_torch.experiments import fused_eval as fe
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import _kernel
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    before = rk.cartpole_rollout.policy_launches
    res = ctrl.evaluate_fused(batch=B, n_steps=T_OFF_POLICY_EVAL, seed=0)
    torch.cuda.synchronize()
    eval_launches = rk.cartpole_rollout.policy_launches - before
    spec = fe.policy_eval_spec(ctrl, ctrl.env)
    s0, cfg, kw = fe.kernel_inputs(spec, ctrl.env, B, 0, False)
    kernel, plain = _kernel('cartpole')[1], _plain_rollout('cartpole')
    k = kernel(s0, cfg, 7, T_OFF_POLICY_CHECK, **kw)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    p = plain(s0, cfg, 7, T_OFF_POLICY_CHECK, **kw)
    e1.record()
    torch.cuda.synchronize()
    state_err, rew_err, flips, ok = _compare_rollouts(k, p)
    ms = time_ms(lambda: kernel(s0, cfg, 8, T_OFF_POLICY_CHECK, **kw), 3)
    pp = kw['policy_params']
    row = dict(path=res['path'], batch=B, T=T_OFF_POLICY_EVAL,
               ctrl_steps_per_s=res['steps_per_sec'], ep_return_mean=res['ep_return_mean'],
               ep_length_mean=res['ep_length_mean'], policy_launches=eval_launches,
               check_T=T_OFF_POLICY_CHECK, state_err=state_err, reward_err=rew_err,
               envs_with_other_counts=flips, ok=ok, ms=ms, plain_ms=e0.elapsed_time(e1),
               actor=f'{pp.nx}->{pp.h1}->{pp.h2}->{pp.nu_out}', card=smi)
    emit('off_policy', part=f'{label} evaluate_fused', **row)
    if res['path'] != 'policy-in-kernel' or eval_launches < 1:
        raise RuntimeError(f'off_policy {label}: evaluate_fused took {res["path"]} with '
                           f'{eval_launches} policy launches')
    if not ok:
        raise RuntimeError(f'off_policy {label}: K4 in policy mode disagrees with its plain '
                           f'version: {row}')
    return row


def off_policy(dev, smi):
    """SAC and DDPG training on the card through the entry points, K1-K3
    stepping every collect; see the module docstring."""
    from safe_control_gym_tpu_torch.controllers.ddpg.ddpg_utils import DDPGAgent
    from safe_control_gym_tpu_torch.controllers.sac.sac_utils import SACAgent
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    t_phase = time.perf_counter()
    rows = {}
    rk.cartpole_rollout.policy_launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        env_id, task, algo = eval_config('sac', 'cartpole')
        sac = _off_policy_ctrl('sac', dev, out_dir, env_id, task,
                               dict(algo, max_env_steps=OFF_POLICY_STEPS))
        row = _off_policy_train('sac cartpole', sac, 'cartpole_advance', smi)
        _zero_launches()
        t0 = time.perf_counter()
        res = sac.run(n_episodes=10)
        row['eval_s'] = time.perf_counter() - t0
        eval_launches = _launches()
        eval_steps = sac.eval_env.func.max_steps + 1
        row.update(eval_return=float(res['ep_returns'].mean()),
                   eval_returns=res['ep_returns'].tolist(), eval_bar=SAC_EVAL_BAR,
                   eval_launches=eval_launches)
        emit('off_policy', part='sac cartpole eval', eval_s=row['eval_s'],
             eval_return=row['eval_return'], eval_returns=row['eval_returns'],
             eval_launches=eval_launches, eval_bar=SAC_EVAL_BAR)
        _expect_launches('off_policy sac eval', eval_launches, 'cartpole_advance', eval_steps)
        if not row['eval_return'] > SAC_EVAL_BAR:
            raise RuntimeError(f'off_policy sac cartpole: eval return {row["eval_return"]} '
                               f'not above {SAC_EVAL_BAR}')
        rows['sac cartpole'] = row
        # One window of a training iteration under the profiler: the collect
        # (policy phase) and the train_interval updates.
        sac._marks = []
        c_wall, c_busy, c_kernels = _profiled(lambda: sac.collect(False), cpu_activity=False)
        u_wall, u_busy, u_kernels = _profiled(sac.train_phase, cpu_activity=False)
        rows['sac trace'] = dict(
            window=f'one collect ({sac.steps_per_iter} steps) and one train phase '
                   f'({int(sac.train_interval)} updates), each under torch.profiler',
            collect_s=c_wall, collect_device_busy_s=c_busy, kernels_per_step=c_kernels
            / sac.steps_per_iter, train_s=u_wall, train_device_busy_s=u_busy,
            kernels_per_update=u_kernels / int(sac.train_interval),
            device_busy_share=(c_busy + u_busy) / (c_wall + u_wall), card=smi)
        emit('off_policy', part='sac trace', **rows['sac trace'])
        kw = {k: getattr(sac, k) for k in ('hidden_dim', 'gamma', 'tau', 'init_temperature',
                                             'use_entropy_tuning', 'target_entropy', 'actor_lr',
                                             'critic_lr', 'entropy_lr', 'activation')}
        rows['sac update'] = _update_pair(SACAgent, sac, kw)
        emit('off_policy', part='sac update card against CPU', **rows['sac update'])
        rows['sac k4'] = _trained_actor_k4('sac cartpole', sac, smi)
        sac.close()
        for system, kname in (('quadrotor_2D', 'quad2d_advance'),
                              ('quadrotor_3D', 'quad3d_advance')):
            env_id, task, algo = eval_config('sac', system)
            n, spi = int(algo['rollout_batch_size']), int(algo['train_interval']) // int(
                algo['rollout_batch_size'])
            warm_iters = -(-int(algo['warm_up_steps']) // (n * spi))
            ctrl = _off_policy_ctrl('sac', dev, out_dir, env_id, task, dict(
                algo, max_env_steps=(warm_iters + OFF_POLICY_QUAD_ITERATIONS) * n * spi))
            rows[f'sac {system}'] = _off_policy_train(f'sac {system}', ctrl, kname, smi)
            ctrl.close()
        ddpg = _off_policy_ctrl('ddpg', dev, out_dir, 'cartpole',
                                dict(normalized_rl_action_space=True), DDPG_TEST)
        row = _off_policy_train('ddpg cartpole', ddpg, 'cartpole_advance', smi)
        a = ddpg.select_action(np.zeros(4, np.float32))
        res = ddpg.run(n_episodes=3)
        row.update(action_at_zero=a.tolist(), eval_returns=res['ep_returns'].tolist())
        emit('off_policy', part='ddpg cartpole checks', action_at_zero=row['action_at_zero'],
             eval_returns=row['eval_returns'])
        if not (abs(float(a[0])) < 0.999 and np.isfinite(res['ep_returns']).all()):
            raise RuntimeError(f'off_policy ddpg: saturated or non-finite: {a}, {res}')
        rows['ddpg cartpole'] = row
        kw = {k: getattr(ddpg, k) for k in ('hidden_dim', 'gamma', 'tau', 'actor_lr',
                                              'critic_lr')}
        rows['ddpg update'] = _update_pair(DDPGAgent, ddpg, kw)
        emit('off_policy', part='ddpg update card against CPU', **rows['ddpg update'])
        rows['ddpg k4'] = _trained_actor_k4('ddpg cartpole', ddpg, smi)
        ddpg.close()
    for name in ('sac update', 'ddpg update'):
        if not rows[name]['max_abs_err'] <= OFF_POLICY_UPDATE_ATOL:
            raise RuntimeError(f'off_policy: the card\'s {name} differs from the CPU\'s: '
                               f'{rows[name]}')
    launches = {
        'cartpole_advance': rows['sac cartpole']['launches']['cartpole_advance']
        + rows['sac cartpole']['eval_launches']['cartpole_advance']
        + rows['ddpg cartpole']['launches']['cartpole_advance'],
        'quad2d_advance': rows['sac quadrotor_2D']['launches']['quad2d_advance'],
        'quad3d_advance': rows['sac quadrotor_3D']['launches']['quad3d_advance'],
        'cartpole_rollout.policy': rows['sac k4']['policy_launches']
        + rows['ddpg k4']['policy_launches']}
    emit('off_policy', part='done', launches=launches, seconds=time.perf_counter() - t_phase,
         card=smi)
    return launches, rows


def _recording(ctrl, n):
    """Wrap ``ctrl``'s ``step_autoreset`` to keep the inputs and next states
    of its first ``n`` steps: (state before, action, next state)."""
    record = []
    step_autoreset = ctrl.func_env.step_autoreset

    def recording(est, act, gen):
        est2, out, obs = step_autoreset(est, act, gen)
        if len(record) < n:
            record.append((est, act.clone(), out.state.clone()))
        return est2, out, obs

    ctrl.func_env.step_autoreset = recording
    return record


def _replay_record(env_id, task_cfg, dev, record):
    """Each recorded step replayed through a card env made with
    ``pallas_physics=False`` (the kernel's plain twin), from the recorded
    state, action and adversary buffer: the largest state difference, and
    the largest adversary force applied."""
    from safe_control_gym_tpu_torch.utils.registration import make
    env = make(env_id, device=dev, pallas_physics=False, **task_cfg)
    err, force = 0.0, 0.0
    for est, act, want in record:
        _, out = env.func.step(est, act)
        err = max(err, float((out.state - want).abs().max()))
        force = max(force, float((est.adv_action * est.adv_valid[:, None]).abs().max()))
    env.close()
    return err, force


def _robust_learner(algo, dev, out_dir, smi, **over):
    """RARL or RAP on tests/test_rarl_behavior.py's cartpole through
    make -> reset -> learn, launches counted and the first ROBUST_REPLAY
    collect steps replayed through the plain twin."""
    from safe_control_gym_tpu_torch.utils.registration import make
    ctrl = make(algo, functools.partial(make, 'cartpole', device=dev, **RARL_TASK),
                training=True, output_dir=os.path.join(out_dir, algo), seed=1,
                checkpoint_path='', max_env_steps=ROBUST_STEPS, **RARL_ALGO, **over)
    record = _recording(ctrl, ROBUST_REPLAY)
    _zero_launches()
    wall = _train(ctrl)
    launches = _launches()
    err, force = _replay_record('cartpole', RARL_TASK, dev, record)
    cycles = ctrl.total_steps / ((int(ctrl.agent_iterations) + int(ctrl.adversary_iterations))
                                 * ctrl.N * ctrl.T)
    last = ctrl.last_results
    row = dict(envs=ctrl.N, T=ctrl.T, hidden=int(ctrl.hidden_dim), total_steps=ctrl.total_steps,
               wall_s=wall, cycles=cycles, seconds_per_cycle=wall / cycles,
               rollout_s=ctrl.train_seconds['rollout'], update_s=ctrl.train_seconds['update'],
               last_results=last, replay_steps=len(record), replay_max_abs_err=err,
               max_adversary_force=force, launches=launches, card=smi)
    emit('robust', part=algo, **row)
    losses = [v for k, v in last.items() if k.endswith('_loss') or k.endswith('_kl')]
    if len(losses) != 8 or not all(np.isfinite(v) for v in losses):
        raise RuntimeError(f'robust {algo}: losses missing or not finite: {last}')
    _expect_launches(f'robust {algo}', launches, 'cartpole_advance', ctrl.total_steps // ctrl.N)
    if err != 0.0 or not force > 0.0 or len(record) != ROBUST_REPLAY:
        raise RuntimeError(f'robust {algo}: replay error {err}, adversary force {force}, '
                           f'{len(record)} steps recorded')
    ctrl.close()
    return row


def _safe_explorer_episode(system, kname, dev, out_dir, smi):
    """The committed SafeExplorerPPO stab model of ``system`` through
    BaseExperiment for one episode, one ``kname`` launch a step; the cartpole
    one gated on tests/test_safe_explorer_behavior.py's bar, the 2D quad's on
    finite actions."""
    from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils.registration import make
    env_id, task, algo = eval_config('safe_explorer_ppo', system)
    env_func = functools.partial(make, env_id, device=dev, **task)
    se = make('safe_explorer_ppo', env_func, training=False,
              output_dir=os.path.join(out_dir, f'se_{system}'), **algo)
    se.load(os.path.join(ROOT, 'examples', 'rl', 'models', 'safe_explorer_ppo',
                         f'safe_explorer_ppo_model_{system}_stab.pt'))
    _zero_launches()
    t0 = time.perf_counter()
    exp = BaseExperiment(env=env_func(), ctrl=se)
    data, metrics = exp.run_evaluation(n_episodes=1, verbose=False)
    exp.close()
    wall = time.perf_counter() - t0
    launches = _launches()
    se.close()
    length = float(metrics['average_length'])
    finite = bool(np.isfinite(np.asarray(data['action'][0], np.float32)).all())
    row = dict(wall_s=wall, ms_per_step=wall / length * 1e3, average_length=length,
               average_return=float(metrics['average_return']),
               average_constraint_violation=float(metrics['average_constraint_violation']),
               actions_finite=finite, launches=launches, card=smi)
    emit('robust', part=f'safe_explorer {system} committed model', **row)
    if system == 'cartpole':
        row['bar_length'] = SE_EVAL_LENGTH
        if not (length >= SE_EVAL_LENGTH and metrics['average_constraint_violation'] == 0):
            raise RuntimeError(f'robust safe_explorer: the committed model misses its bar: '
                               f'{metrics}')
    elif not (finite and np.isfinite(row['average_return'])):
        raise RuntimeError(f'robust safe_explorer {system}: non-finite actions or return')
    _expect_launches(f'robust safe_explorer {system}', launches, kname, int(length))
    return row


def robust(dev, smi):
    """RARL, RAP and SafeExplorerPPO on the card through the entry points,
    K1 (and K2) stepping every collect with the adversary's force; see the
    module docstring."""
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils.registration import make
    t_phase = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory() as out_dir:
        rows['rarl'] = _robust_learner('rarl', dev, out_dir, smi)
        rows['rap'] = _robust_learner('rap', dev, out_dir, smi, num_adversaries=2)
        # One RARL rollout on the 2D quad: K2 takes the adversary's world force.
        quad_task = dict(RARL_TASK, quad_type=2, ctrl_freq=50, pyb_freq=1000)
        ctrl = make('rarl', functools.partial(make, 'quadrotor', device=dev, **quad_task),
                    training=True, output_dir=os.path.join(out_dir, 'quad'), seed=1,
                    checkpoint_path='', **dict(RARL_ALGO, rollout_steps=ROBUST_QUAD_T))
        ctrl.reset()
        record = _recording(ctrl, ROBUST_QUAD_T)
        _zero_launches()
        ctrl.rollout(True)
        torch.cuda.synchronize()
        launches = _launches()
        err, force = _replay_record('quadrotor', quad_task, dev, record)
        rows['rarl quadrotor_2D'] = dict(envs=ctrl.N, T=ROBUST_QUAD_T, replay_max_abs_err=err,
                                         max_adversary_force=force, launches=launches)
        emit('robust', part='rarl quadrotor_2D rollout', **rows['rarl quadrotor_2D'])
        _expect_launches('robust rarl quadrotor_2D', launches, 'quad2d_advance', ROBUST_QUAD_T)
        if err != 0.0 or not force > 0.0:
            raise RuntimeError(f'robust rarl quadrotor_2D: replay error {err}, force {force}')
        ctrl.close()
        # SafeExplorerPPO: the committed stab models' episodes. The cartpole
        # file's PPO parameters are NaN (in the JAX package too): its actions
        # are NaN, and the bar of tests/test_safe_explorer_behavior.py holds
        # because NaN states violate nothing. The 2D quad's are finite.
        for system, kname in (('cartpole', 'cartpole_advance'), ('quadrotor_2D', 'quad2d_advance')):
            rows[f'safe_explorer {system}'] = _safe_explorer_episode(system, kname, dev, out_dir,
                                                                     smi)
        # The committed pretrain config, cut in depth.
        env_id, task, algo = eval_config('safe_explorer_ppo', 'cartpole', 'pretrain')
        algo = dict(algo, constraint_epochs=SE_EPOCHS,
                    max_env_steps=int(algo['rollout_batch_size']) * int(algo['rollout_steps']))
        se = make('safe_explorer_ppo', functools.partial(make, env_id, device=dev, **task),
                  training=True, output_dir=os.path.join(out_dir, 'se'), seed=0,
                  checkpoint_path='', **algo)
        _zero_launches()
        wall = _train(se)
        launches = _launches()
        pre_steps = SE_EPOCHS * (int(algo['constraint_steps_per_epoch']) // se.N)
        last = se.last_results
        rows['safe_explorer train'] = dict(
            envs=se.N, T=se.T, constraint_epochs=SE_EPOCHS, pretrain_steps=pre_steps,
            total_steps=se.total_steps, wall_s=wall,
            pretrain_s=se.train_seconds['pretrain_collect'] + se.train_seconds['pretrain_fit'],
            **se.train_seconds, last_results=last, launches=launches, card=smi)
        emit('robust', part='safe_explorer pretrain and PPO', **rows['safe_explorer train'])
        se.close()
        if not all(np.isfinite(v) for v in last.values()):
            raise RuntimeError(f'robust safe_explorer: a loss is not finite: {last}')
        _expect_launches('robust safe_explorer train', launches, 'cartpole_advance',
                         pre_steps + se.T)
    launches = {'cartpole_advance': sum(rows[k]['launches']['cartpole_advance'] for k in (
        'rarl', 'rap', 'safe_explorer cartpole', 'safe_explorer train')),
                'quad2d_advance': rows['rarl quadrotor_2D']['launches']['quad2d_advance']
                + rows['safe_explorer quadrotor_2D']['launches']['quad2d_advance']}
    emit('robust', part='done', launches=launches, seconds=time.perf_counter() - t_phase,
         card=smi)
    return launches, rows


def _exp_train(dev, out_dir, smi):
    """train() of ppo_cartpole cut to two iterations: its config against the
    committed JSON copy, K1's launches, finite losses, model_latest.pt into a
    fresh controller, --restore."""
    from safe_control_gym_tpu_torch.experiments import train_rl_controller as trc
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils import yaml_io
    from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
    from safe_control_gym_tpu_torch.utils.registration import make
    from safe_control_gym_tpu_torch.utils.utils import unmunchify
    argv = (['--algo', 'ppo', '--task', 'cartpole', '--overrides'] + EXP_RL_OVERRIDES
            + ['--kv_overrides', f'algo_config.max_env_steps={EXP_TRAIN_STEPS}', '--seed', '0',
               '--device', str(dev.type), '--output_dir', out_dir])
    config = ConfigFactory().merge(argv=argv)
    _, task_ref, algo_ref = eval_config('ppo', 'cartpole')
    differ = sorted([f'task_config.{k}' for k, v in task_ref.items()
                     if config.task_config.get(k) != v]
                    + [f'algo_config.{k}' for k, v in algo_ref.items()
                       if config.algo_config.get(k) != v and k != 'max_env_steps'])
    made = []

    def recording_make(idx, *args, **kwargs):
        obj = make(idx, *args, **kwargs)
        made.append(obj)
        return obj

    trc.make = recording_make
    try:
        _zero_launches()
        t0 = time.perf_counter()
        run_dir = trc.train(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
    finally:
        trc.make = make
    ctrl = made[-1]
    iterations = ctrl.total_steps // (ctrl.N * ctrl.T)
    saved = yaml_io.load_file(os.path.join(run_dir, 'config.yaml'))
    fresh = make('ppo', functools.partial(make, 'cartpole', device=dev,
                                          **saved['task_config']),
                 output_dir=os.path.join(out_dir, 'fresh'), **saved['algo_config'])
    fresh.load(os.path.join(run_dir, 'model_latest.pt'))
    obs = np.random.default_rng(0).normal(0.0, 0.2, (B, 4)).astype(np.float32)
    same_actions = bool(np.array_equal(fresh.select_action(obs), ctrl.select_action(obs)))
    restored = unmunchify(ConfigFactory().merge(argv=['--restore', run_dir]))
    restore_ok = restored.pop('restore') == run_dir and saved.pop('restore') is None \
        and restored == saved
    last = ctrl.last_results
    losses = {k: last[k] for k in ('policy_loss', 'value_loss', 'entropy_loss', 'approx_kl')}
    row = dict(envs=ctrl.N, T=ctrl.T, iterations=iterations, total_steps=ctrl.total_steps,
               wall_s=wall, rollout_s=ctrl.train_seconds['rollout'],
               update_s=ctrl.train_seconds['update'], losses=losses,
               config_differs_from_json_copy=differ, loaded_acts_identically=same_actions,
               restore_gives_config=restore_ok, launches=launches, card=smi)
    emit('experiment', part='train', **row)
    fresh.close()
    if differ:
        raise RuntimeError(f'experiment train: the merged config differs from the JSON '
                           f'copies in {differ}')
    _expect_launches('experiment train', launches, 'cartpole_advance', 2 * 150)
    if iterations != 2 or not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f'experiment train: {iterations} iterations, losses {losses}')
    if not same_actions or not restore_ok:
        raise RuntimeError(f'experiment train: loaded model acts identically {same_actions}, '
                           f'--restore gives the config {restore_ok}')
    return row


def _exp_vec_env(dev, smi):
    """make_vec_envs on the three systems at B_VEC: held to
    FuncEnv.step_autoreset on the same generator (0.0), one K1/K2/K3 launch a
    step, the episode statistics against the done flags."""
    from safe_control_gym_tpu_torch.envs.env_wrappers.record_episode_statistics import \
        VecRecordEpisodeStatistics
    from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env import make_vec_envs
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils.registration import make
    rows = {}
    for system, model in (('cartpole', 'cartpole'), ('quadrotor', 'quadrotor_2D'),
                          ('quadrotor_3D', 'quadrotor_3D')):
        env_id, task, _ = eval_config('ppo', model)
        env_func = functools.partial(make, env_id, device=dev, **task)
        venv = VecRecordEpisodeStatistics(make_vec_envs(env_func, batch_size=B_VEC, seed=1))
        gen = torch.Generator(device=dev).manual_seed(2)
        acts = torch.rand((T_VEC, B_VEC, NU[system]), generator=gen, device=dev) * 2 - 1
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [(venv.reset(), None, None)]
        for t in range(T_VEC):
            obs, rew, done, _ = venv.step(acts[t])
            out.append((obs, rew, done))
        wall = time.perf_counter() - t0
        launches = _launches()
        func = make(env_id, device=dev, **task).func
        ref_gen = torch.Generator(device=dev).manual_seed(1)
        est, ref_obs = func.reset_batch(ref_gen, B_VEC)
        err = float(np.abs(out[0][0] - ref_obs.cpu().numpy()).max())
        dones = 0
        for t in range(T_VEC):
            est, step, ref_obs = func.step_autoreset(est, acts[t], ref_gen)
            obs, rew, done = out[t + 1]
            err = max(err, float(np.abs(obs - ref_obs.cpu().numpy()).max()),
                      float(np.abs(rew - step.reward.cpu().numpy()).max()))
            if not np.array_equal(done, step.done.cpu().numpy()):
                err = float('inf')
            dones += int(done.sum())
        row = dict(envs=B_VEC, T=T_VEC, seconds=wall, ctrl_steps_per_s=B_VEC * T_VEC / wall,
                   max_abs_err=err, episodes=dones, recorded_episodes=len(venv.return_queue),
                   mean_episode_length=float(np.mean(venv.length_queue)) if dones else None,
                   launches=launches, card=smi)
        rows[system] = row
        emit('experiment', part=f'vec_env {system}', **row)
        venv.close()
        if err != 0.0 or dones == 0 or len(venv.return_queue) != dones:
            raise RuntimeError(f'experiment vec_env {system}: {row}')
        _expect_launches(f'experiment vec_env {system}', launches, PHYSICS[system]['name'],
                         T_VEC)
    return rows


def _hpo(dev, out_dir, *kv):
    from safe_control_gym_tpu_torch.hyperparameters.hpo import HPO
    from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
    argv = (['--algo', 'ppo', '--task', 'cartpole', '--overrides'] + EXP_HPO_OVERRIDES
            + ['--device', str(dev.type), '--output_dir', out_dir, '--kv_overrides',
               f'algo_config.max_env_steps={EXP_HPO_STEPS}', *kv])
    config = ConfigFactory().merge(argv=argv)
    return HPO(config.algo, config.task, output_dir=config.output_dir,
               task_config=config.task_config, algo_config=config.algo_config,
               hpo_config=config.hpo_config, device=config.device), config


def _population_update(pop, pop_cpu, draws, hp_arrays):
    """The population's first update (all epochs, and its first epoch alone)
    on the card against a CPU copy on the same batch (the card's first
    rollout) and permutations; and the CPU's own spread: its update of the
    batch with the observations moved by 1e-7 of their size.
    Returns each lane's largest parameter difference of each comparison, and
    the card's parameters after the whole update."""
    from safe_control_gym_tpu_torch.hyperparameters import population as popmod
    from safe_control_gym_tpu_torch.math.optim import tree_leaves, tree_unflatten
    P = len(draws['iterations'][0]['perms'][0])
    hp = pop.hp_tensors(hp_arrays, P)
    params = draws['params']
    est, obs = draws['init']
    _, _, batch = pop.rollout(params, hp, est, obs, draws['iterations'][0])
    perms = draws['iterations'][0]['perms']
    cpu_params = tree_unflatten(params, [x.cpu() for x in tree_leaves(params)])
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu_hp = pop_cpu.hp_tensors(hp_arrays, P)

    def update(p, ev, h, b, epochs):
        actor = tree_leaves({k: p[k] for k in ('actor', 'logstd')})
        new, a_opt, _ = ev.update(p, popmod.adam_init(actor),
                                  popmod.adam_init(tree_leaves(p['critic'])), h, b,
                                  perms[:epochs].to(ev.device))
        return new, a_opt['t'].cpu().numpy()

    def lane_err(a, b):
        return np.array([max(float((x[lane].cpu() - y[lane].cpu()).abs().max())
                             for x, y in zip(tree_leaves(a), tree_leaves(b)))
                         for lane in range(P)])

    epochs = perms.shape[0]
    card, card_steps = update(params, pop, hp, batch, epochs)
    cpu, cpu_steps = update(cpu_params, pop_cpu, cpu_hp, cpu_batch, epochs)
    card1, _ = update(params, pop, hp, batch, 1)
    cpu1, _ = update(cpu_params, pop_cpu, cpu_hp, cpu_batch, 1)
    moved = dict(cpu_batch, obs=cpu_batch['obs'] * (1 + 1e-7))
    spread = lane_err(cpu, update(cpu_params, pop_cpu, cpu_hp, moved, epochs)[0])
    return dict(epochs=epochs, minibatches=pop.num_mb,
                one_epoch_max_abs_err=float(lane_err(card1, cpu1).max()),
                lane_max_abs_err=lane_err(card, cpu).tolist(),
                cpu_spread=spread.tolist(),
                accepted_actor_steps_card=card_steps.tolist(),
                accepted_actor_steps_cpu=cpu_steps.tolist()), card


def _exp_hpo(dev, out_dir, smi):
    """Two sequential trials of examples/hpo's PPO config, then one vectorized
    round as one population; the population's update card against CPU and a
    lane against a one-lane population on the same draws."""
    from safe_control_gym_tpu_torch.hyperparameters import population as popmod
    from safe_control_gym_tpu_torch.math.optim import tree_leaves
    from safe_control_gym_tpu_torch.utils.registration import make
    rows = {}
    hpo, config = _hpo(dev, os.path.join(out_dir, 'seq'), 'hpo_config.trials=2')
    _zero_launches()
    t0 = time.perf_counter()
    study = hpo.hyperparameter_optimization()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    hpo.close()
    per_trial = 2 * 100 + 251
    done = [t for t in study.trials if t['state'] == 'COMPLETE']
    row = dict(trials=len(study.trials), completed=len(done),
               values=[t['value'] for t in study.trials],
               params=[t['params'] for t in study.trials], seconds=wall,
               seconds_per_trial=wall / 2,
               trials_csv=os.path.exists(os.path.join(out_dir, 'seq', 'trials.csv')),
               launches=launches, card=smi)
    rows['sequential'] = row
    emit('experiment', part='hpo sequential', **row)
    if len(done) != 2 or not row['trials_csv'] or not all(np.isfinite(row['values'])):
        raise RuntimeError(f'experiment hpo sequential: {row}')
    _expect_launches('experiment hpo sequential', launches, 'cartpole_advance',
                     2 * per_trial)
    hpo, config = _hpo(dev, os.path.join(out_dir, 'vec'), f'hpo_config.trials={HPO_TRIALS}',
                       f'hpo_config.vectorized_trials={HPO_TRIALS}',
                       f'hpo_config.repetitions={HPO_REPS}',
                       f'hpo_config.n_episodes={HPO_N_EVAL}',
                       'hpo_config.hps_config=' + repr({k: 1 for k in HPO_VECTOR_SPACE}))
    _zero_launches()
    study = hpo.hyperparameter_optimization()
    torch.cuda.synchronize()
    launches = _launches()
    hpo.close()
    rounds = hpo.vectorized_rounds
    lanes = HPO_TRIALS * HPO_REPS
    done = [t for t in study.trials if t['state'] == 'COMPLETE']
    row = dict(trials=HPO_TRIALS, repetitions=HPO_REPS, lanes=lanes, envs=lanes * 16,
               rounds=rounds, seconds=rounds[0]['seconds'] if rounds else None,
               lane_trainings_per_s=lanes / rounds[0]['seconds'] if rounds else None,
               values=[t['value'] for t in done], launches=launches, card=smi)
    rows['vectorized'] = row
    emit('experiment', part='hpo vectorized round', **row)
    if len(rounds) != 1 or rounds[0]['lanes'] != lanes or len(done) != HPO_TRIALS:
        raise RuntimeError(f'experiment hpo vectorized: {row}')
    _expect_launches('experiment hpo vectorized', launches, 'cartpole_advance', per_trial)
    # The population itself, at the round's shape with lanes of moderate
    # learning rates: its update on the card against the CPU, and lane
    # POP_LANE against a one-lane population fed the same draws.
    cfg = config.algo_config
    kw = dict(rollout_batch_size=cfg.rollout_batch_size, rollout_steps=cfg.rollout_steps,
              iterations=EXP_HPO_STEPS // (cfg.rollout_batch_size * cfg.rollout_steps),
              opt_epochs=cfg.opt_epochs, mini_batch_size=cfg.mini_batch_size,
              hidden_dim=cfg.hidden_dim, activation=cfg.activation, use_gae=cfg.use_gae,
              n_eval=HPO_N_EVAL)
    env_func = functools.partial(make, 'cartpole', seed=0, **config.task_config)
    pop = popmod.make_population_ppo_evaluator(env_func, device=dev, **kw)
    pop_cpu = popmod.make_population_ppo_evaluator(env_func, device='cpu', **kw)
    seeds = list(range(100, 100 + lanes))
    rng = np.random.default_rng(0)
    hp_arrays = {'actor_lr': 10 ** rng.uniform(-4, -2.5, lanes),
                 'critic_lr': 10 ** rng.uniform(-3.5, -2.5, lanes),
                 'entropy_coef': 10 ** rng.uniform(-4, -1.5, lanes),
                 'target_kl': rng.uniform(0.005, 0.05, lanes)}
    draws = pop.lane_draws(seeds)
    upd, trained = _population_update(pop, pop_cpu, draws, hp_arrays)
    repeatable = np.asarray(upd['cpu_spread']) <= POP_REPEATABLE
    upd['repeatable_lanes'] = np.flatnonzero(repeatable).tolist()
    upd_ok = (upd['one_epoch_max_abs_err'] <= POP_UPDATE_ATOL
              and repeatable.mean() >= POP_REPEATABLE_SHARE
              and bool(np.all(np.asarray(upd['lane_max_abs_err'])[repeatable]
                              <= POP_UPDATE_ATOL))
              and upd['accepted_actor_steps_card'] == upd['accepted_actor_steps_cpu'])
    # Lane POP_LANE after the first iteration (the rollout and the whole
    # update above), and its evaluation, against a one-lane population.
    one_draws = pop.select_lanes(draws, [POP_LANE])
    one_hp = pop.hp_tensors({k: v[POP_LANE:POP_LANE + 1] for k, v in hp_arrays.items()}, 1)
    params = one_draws['params']
    _, _, batch = pop.rollout(params, one_hp, *one_draws['init'], one_draws['iterations'][0])
    one_trained = pop.update(
        params, popmod.adam_init(tree_leaves({k: params[k] for k in ('actor', 'logstd')})),
        popmod.adam_init(tree_leaves(params['critic'])), one_hp, batch,
        one_draws['iterations'][0]['perms'])[0]
    param_err = max(float((a[POP_LANE] - b[0]).abs().max())
                    for a, b in zip(tree_leaves(trained), tree_leaves(one_trained)))
    lane_returns = pop.evaluate_params(trained, popmod._FedDraws(draws),
                                       lanes)[POP_LANE].cpu().numpy()
    one = pop.evaluate_params(one_trained, popmod._FedDraws(one_draws), 1)[0].cpu().numpy()
    lane_err = float(np.abs(lane_returns - one).max())
    scale = float(np.abs(lane_returns).max())
    row = dict(lanes=lanes, update=upd, update_atol=POP_UPDATE_ATOL,
               repeatable_below=POP_REPEATABLE, lane=POP_LANE,
               lane_param_max_abs_err=param_err, lane_returns=lane_returns.tolist(),
               one_lane_returns=one.tolist(), lane_max_abs_err=lane_err,
               lane_rtol=POP_LANE_RTOL, card=smi)
    rows['population'] = row
    emit('experiment', part='population card against CPU and lane against one lane', **row)
    if not upd_ok:
        raise RuntimeError(f'experiment population: the card\'s update differs from the '
                           f'CPU\'s: {upd}')
    if not (param_err <= POP_UPDATE_ATOL and lane_err <= POP_LANE_RTOL * max(scale, 1.0)):
        raise RuntimeError(f'experiment population: lane {POP_LANE} differs from the '
                           f'one-lane population: {row}')
    return rows


def experiment(dev, smi):
    """The experiment layer on the card through the examples' entry points:
    train(), make_vec_envs and HPO with its population; see the module
    docstring."""
    t_phase = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory() as out_dir:
        rows['train'] = _exp_train(dev, out_dir, smi)
        rows['vec_env'] = _exp_vec_env(dev, smi)
        rows.update(_exp_hpo(dev, out_dir, smi))
    launches = {m['name']: 0 for m in PHYSICS.values()}
    for part in [rows['train'], rows['sequential'], rows['vectorized']] + list(
            rows['vec_env'].values()):
        for name in launches:
            launches[name] += part['launches'][name]
    emit('experiment', part='done', launches=launches, seconds=time.perf_counter() - t_phase,
         card=smi)
    return launches, rows

def _est_rows(est, rows, dev):
    """The first ``rows`` envs of an EnvState on ``dev``: every batched field,
    per-env parameters included, cut; shared parameters moved."""
    cut = lambda t: (t[:rows] if t.ndim else t).to(dev)
    params = dataclasses.replace(est.dyn_params, **{
        f.name: cut(getattr(est.dyn_params, f.name))
        for f in dataclasses.fields(est.dyn_params)})
    return est.replace(dyn_params=params, **{f.name: cut(getattr(est, f.name))
                                             for f in dataclasses.fields(est)
                                             if f.name != 'dyn_params'})


def _extras_case(label, env_id, kw, dev, smi, T, actions=None, x0=None, randomized=False):
    """step_autoreset of a B_EXTRAS batch on the card, T steps, the first
    EXTRAS_CPU_ROWS envs repeated on the CPU from the card's reset draws:
    states within EXTRAS_ATOL, reward sums within EXTRAS_ATOL relative, done
    counts and step counters equal; with ``randomized``, the envs that were
    not done keep their parameters exactly and the done ones take the fresh
    draw's. ``actions`` (T, B, nu) default to uniform draws over the action
    space; ``x0`` replaces the first states. Returns the row (ms a step of
    the card's step alone, K1-K3 launches a step, the route, and one more
    step under the profiler: its CUDA kernels and the device's busy share)."""
    from safe_control_gym_tpu_torch.utils.registration import make
    env = make(env_id, device=dev, **kw)
    cpu = make(env_id, device='cpu', **kw)
    R = EXTRAS_CPU_ROWS
    gen = torch.Generator(device=dev).manual_seed(5)
    cpu_gen = torch.Generator().manual_seed(5)
    if actions is None:
        lo = torch.as_tensor(env.action_space.low, device=dev)
        hi = torch.as_tensor(env.action_space.high, device=dev)
        actions = lo + torch.rand((T, B_EXTRAS, env.action_dim), generator=gen,
                                  device=dev) * (hi - lo)
    est, _ = env.func.reset_batch(gen, B_EXTRAS)
    if x0 is not None:
        est = est.replace(state=x0)
    est_cpu = _est_rows(est, R, 'cpu')
    first_params = est.dyn_params
    z = lambda d, n: torch.zeros(n, device=d)
    rew, dn, rew_cpu, dn_cpu = z(dev, B_EXTRAS), z(dev, B_EXTRAS), z('cpu', R), z('cpu', R)
    kept_ok = True
    before = _launches()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    step_ms = 0.0
    for t in range(T):
        fresh = env.func.reset_batch(gen, B_EXTRAS)
        fresh_cpu = (_est_rows(fresh[0], R, 'cpu'), fresh[1][:R].cpu())
        e0.record()
        new, out, _ = env.func.step_autoreset(est, actions[t], gen, fresh=fresh)
        e1.record()
        torch.cuda.synchronize()
        step_ms += e0.elapsed_time(e1)
        if randomized:
            for f in dataclasses.fields(new.dyn_params):
                old_v, new_v = getattr(est.dyn_params, f.name), getattr(new.dyn_params, f.name)
                if new_v.ndim:
                    kept_ok &= bool(torch.equal(new_v[~out.done], old_v[~out.done]))
                    kept_ok &= bool(torch.equal(new_v[out.done],
                                                getattr(fresh[0].dyn_params, f.name)[out.done]))
        est = new
        rew += out.reward
        dn += out.done
        est_cpu, out_cpu, _ = cpu.func.step_autoreset(est_cpu, actions[t, :R].cpu(), cpu_gen,
                                                      fresh=fresh_cpu)
        rew_cpu += out_cpu.reward
        dn_cpu += out_cpu.done
    launches = _launches(before)
    # One more card step under the profiler: CUDA kernels a step, busy share.
    p_wall, p_busy, p_kernels = _profiled(
        lambda: env.func.step_autoreset(est, actions[-1], gen), cpu_activity=False)
    state_err = float((est.state[:R].cpu() - est_cpu.state).abs().max())
    rew_card = rew[:R].cpu()
    rew_err = float(((rew_card - rew_cpu).abs() / (1 + rew_cpu.abs())).max())
    counts_equal = bool(torch.equal(dn[:R].cpu(), dn_cpu)
                        and torch.equal(est.ctrl_step[:R].cpu(), est_cpu.ctrl_step))
    row = dict(case=label, route=env.physics_route, envs=B_EXTRAS, T=T, cpu_rows=R,
               ms_per_step=step_ms / T,
               launches_per_step={k: v / T for k, v in launches.items() if v},
               kernels_per_step=p_kernels, device_busy_share=p_busy / p_wall,
               state_err=state_err, reward_err=rew_err, counts_equal=counts_equal,
               done_count=float(dn.sum()), card=smi)
    if randomized:
        row['params_kept_and_redrawn'] = kept_ok
        row['first_params'] = first_params
    emit('env_extras', **{k: v for k, v in row.items() if k != 'first_params'})
    if not (state_err <= EXTRAS_ATOL and rew_err <= EXTRAS_ATOL and counts_equal
            and kept_ok and row['done_count'] > 0):
        raise RuntimeError(f'env_extras {label}: card against CPU: {row}')
    return row


def _near_ground(quad_type, dev):
    """B_EXTRAS starts near the ground (z in [0.02, 0.3]) with velocities up
    to 2 m/s and angles and rates off zero (tests/test_torch_quad_physics_modes.py)."""
    gen = torch.Generator(device=dev).manual_seed(quad_type)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(B_EXTRAS, generator=gen, device=dev)
    nx = {1: 2, 2: 6, 3: 12}[quad_type]
    zi = {1: 0, 2: 2, 3: 4}[quad_type]
    x = torch.zeros((B_EXTRAS, nx), device=dev)
    x[:, zi], x[:, zi + 1] = u(0.02, 0.3), u(-2, 2)
    if quad_type == 2:
        x[:, 0], x[:, 1], x[:, 4], x[:, 5] = u(-1, 1), u(-2, 2), u(-0.4, 0.4), u(-1, 1)
    if quad_type == 3:
        for k, (lo, hi) in zip((0, 1, 2, 3, 6, 7, 8, 9, 10, 11),
                               ((-1, 1), (-2, 2), (-1, 1), (-2, 2)) + ((-0.4, 0.4),) * 3
                               + ((-1, 1),) * 3):
            x[:, k] = u(lo, hi)
    return x


def _spec_moments(spec, nominal):
    """The mean, variance and fourth central moment of an additive draw of
    ``spec`` about ``nominal`` (uniform or choice)."""
    if spec['distrib'] == 'uniform':
        lo, hi = spec['low'], spec['high']
        return nominal + (lo + hi) / 2, (hi - lo) ** 2 / 12, (hi - lo) ** 4 / 80
    opts = np.asarray(spec['args'][0], np.float64)
    return nominal + opts.mean(), opts.var(), ((opts - opts.mean()) ** 4).mean()


def env_extras(dev, smi):
    """The 1D quad, the physics modes, domain randomization and rendering on
    the card; see the module docstring."""
    from safe_control_gym_tpu_torch.utils.registration import make
    t_phase = time.perf_counter()
    rows = {}
    # The 1D quad: random actions with auto-reset.
    env_id, kw = EXTRAS_QUAD[1]
    rows['quad1d'] = _extras_case('quad1d pyb', env_id, dict(EXTRAS_BASE, **kw), dev, smi,
                                     T_EXTRAS_1D)
    # The modes from near-ground, moving starts, thrusts about hover; 'pyb'
    # of the 2D and 3D quads takes K2/K3, every other case the general
    # advance.
    for qt, modes in ((1, ('pyb_gnd',)), (2, EXTRAS_MODES), (3, EXTRAS_MODES)):
        env_id, kw = EXTRAS_QUAD[qt]
        kname = PHYSICS['quadrotor' if qt == 2 else 'quadrotor_3D']['name'] if qt > 1 else None
        x0 = _near_ground(qt, dev)
        for physics in modes:
            kw_m = dict(EXTRAS_BASE, randomized_init=False, physics=physics, **kw)
            hover = float(make(env_id, device=dev, **kw_m).U_GOAL[0])
            gen = torch.Generator(device=dev).manual_seed(10 + qt)
            acts = hover * (0.5 + 1.1 * torch.rand(
                (T_EXTRAS_MODES[qt], B_EXTRAS, NU_QUAD[qt]), generator=gen, device=dev))
            row = _extras_case(f'quad{qt}d {physics}', env_id, kw_m, dev, smi,
                               T_EXTRAS_MODES[qt], actions=acts, x0=x0)
            want = 1.0 if physics == 'pyb' and qt > 1 else 0.0
            if kname is not None and row['launches_per_step'].get(kname, 0.0) != want:
                raise RuntimeError(f'env_extras quad{qt}d {physics}: {kname} launches a step '
                                   f'{row["launches_per_step"]}, {want} expected')
            rows[f'quad{qt}d {physics}'] = row
        # Each mode's effect: T_EXTRAS_EFFECT hover steps from the same starts
        # against 'pyb': the ground effect and the drag (not in 1D) move the
        # states, downwash (one drone) does not.
        finals = {}
        for physics in ('pyb',) + modes if qt == 1 else EXTRAS_MODES:
            e = make(env_id, device=dev, **dict(EXTRAS_BASE, randomized_init=False,
                                               physics=physics, **kw))
            est, _ = e.func.reset_batch(torch.Generator(device=dev).manual_seed(0), B_EXTRAS)
            est = est.replace(state=x0)
            u = torch.as_tensor(np.tile(e.U_GOAL, (B_EXTRAS, 1)), dtype=torch.float32,
                                device=dev)
            for _ in range(T_EXTRAS_EFFECT):
                est, _ = e.func.step(est, u)
            finals[physics] = est.state
        effect = {m: float((finals[m] - finals['pyb']).abs().max()) for m in finals if m != 'pyb'}
        rows[f'quad{qt}d effect'] = effect
        emit('env_extras', case=f'quad{qt}d modes against pyb', T=T_EXTRAS_EFFECT,
             max_abs_diff=effect, card=smi)
        for m, d in effect.items():
            if (m in ('pyb_gnd', 'pyb_drag', 'pyb_gnd_drag_dw') and not d > 1e-6) or \
                    (m == 'pyb_dw' and not d <= EXTRAS_ATOL):
                raise RuntimeError(f'env_extras quad{qt}d {m} against pyb: {d}')
    # Randomized inertial properties, with the shared-parameter case beside.
    for system, env_id, kw in (('cartpole', 'cartpole', {}),
                               ('quadrotor', *EXTRAS_QUAD[2]),
                               ('quadrotor_3D', *EXTRAS_QUAD[3])):
        kname = PHYSICS[system]['name']
        kw_r = dict(EXTRAS_BASE, randomized_inertial_prop=True, **kw)
        row = _extras_case(f'{system} randomized', env_id, kw_r, dev, smi,
                           T_EXTRAS_RAND[system], randomized=True)
        shared = _extras_case(f'{system} shared', env_id, dict(EXTRAS_BASE, **kw), dev, smi,
                              T_EXTRAS_RAND[system])
        if row['launches_per_step'].get(kname, 0) != 0 or \
                shared['launches_per_step'].get(kname) != 1.0:
            raise RuntimeError(f'env_extras {system}: {kname} launches a step: randomized '
                               f'{row["launches_per_step"]}, shared '
                               f'{shared["launches_per_step"]}')
        env = make(env_id, device=dev, **kw_r)
        welch_rows = {}
        params = row.pop('first_params')
        for name, spec in env.INERTIAL_PROP_RAND_INFO.items():
            field = {'M': 'mass'}.get(name, name)
            drawn = getattr(params, field).double().cpu().numpy()
            mean, var, mu4 = _spec_moments(spec,
                                           float(getattr(env._nominal_dyn_params(), field)))
            # z of the sample mean and of the sample variance against the spec's.
            zval = abs(drawn.mean() - mean) / np.sqrt(var / drawn.size)
            z_var = abs(drawn.var() - var) / np.sqrt((mu4 - var ** 2) / drawn.size)
            welch_rows[field] = dict(mean=drawn.mean(), spec_mean=mean, z=zval,
                                     var_ratio=drawn.var() / var, z_var=z_var)
            if not (zval <= 6.0 and z_var <= 6.0):
                raise RuntimeError(f'env_extras {system}: {field} draws against the spec: '
                                   f'{welch_rows[field]}')
        emit('env_extras', case=f'{system} randomized draws', draws=B_EXTRAS, moments=welch_rows)
        rows[f'{system} randomized'], rows[f'{system} shared'] = row, shared
    rows['render'] = _extras_render(dev, smi)
    launches = {m['name']: 0 for m in PHYSICS.values()}
    for row in rows.values():
        for name, per_step in row.get('launches_per_step', {}).items():
            if name in launches:
                launches[name] += int(round(per_step * row['T']))
    emit('env_extras', part='done', launches=launches, seconds=time.perf_counter() - t_phase,
         card=smi)
    return launches, rows


def _extras_render(dev, smi):
    """A card env and a CPU env stepped alike: the host mirror of the state
    (what a frame is drawn from) within EXTRAS_ATOL; where matplotlib is
    installed, the card env's frame equal to the CPU env's put in the same
    state, and a gui=True env's viewer redrawn at every reset and step."""
    import importlib.util
    from safe_control_gym_tpu_torch.utils.registration import make
    kw = dict(EXTRAS_BASE, randomized_init=False, init_state={'init_z': 1.0}, **EXTRAS_QUAD[3][1])
    card_env, cpu_env = (make('quadrotor', device=d, **kw) for d in (dev, 'cpu'))
    for e in (card_env, cpu_env):
        e.reset()
        for _ in range(5):
            e.step(1.05 * e.U_GOAL)
    row = dict(state_err=float(np.abs(card_env.state - cpu_env.state).max()), card=smi)
    if importlib.util.find_spec('matplotlib') is None:
        row['frames'] = 'not drawn: matplotlib is not installed on this machine'
    else:
        cpu_env.state = card_env.state.copy()
        row['frames_equal'] = bool(np.array_equal(card_env.render(), cpu_env.render()))
        gui = make('cartpole', device=dev, gui=True, **EXTRAS_BASE)
        gui.reset()
        for _ in range(3):
            gui.step(np.zeros(1, np.float32))
        row['viewer_frames'] = gui._viewer.frame_count
        gui.close()
    emit('env_extras', case='render', **row)
    if not (row['state_err'] <= EXTRAS_ATOL and row.get('frames_equal', True)
            and row.get('viewer_frames', 4) == 4):
        raise RuntimeError(f'env_extras render: {row}')
    return row


def _sync(dev):
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize(dev)


def _mg_leaves(tree):
    from safe_control_gym_tpu_torch.math.optim import tree_leaves
    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def _mg_adam(state):
    return [state['count'].cpu().numpy()] + _mg_leaves(state['mu']) + _mg_leaves(state['nu'])


def _mg_ppo(dev, mesh, out_dir, model_axis=None):
    from safe_control_gym_tpu_torch.utils.registration import make
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    env_id, task_cfg, algo_cfg = eval_config('ppo', 'cartpole')
    algo_cfg = dict(algo_cfg, max_env_steps=MG_PPO_ITERATIONS * 64 * 150, eval_interval=0,
                    log_interval=0, save_interval=0, opt_epochs=MG_PPO_EPOCHS)
    ctrl = make('ppo', functools.partial(make, env_id, device=dev, **task_cfg), training=True,
                output_dir=out_dir, seed=0, checkpoint_path='', **algo_cfg)
    ctrl.reset()
    if mesh is not None:
        ctrl.shard_over(mesh, model_axis=model_axis)
    ctrl.learn()
    ag = ctrl.agent
    return dict(params=_mg_leaves(ag.full_params()), shards=_mg_leaves(ag.params),
                replicas=_mg_leaves(ag.params) + _mg_adam(ag.actor_opt_state)
                + _mg_adam(ag.critic_opt_state), envs=ctrl._obs.shape[0],
                last=ctrl.last_results)


def _mg_sac(dev, mesh, out_dir):
    from safe_control_gym_tpu_torch.utils.registration import make
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    env_id, task_cfg, algo_cfg = eval_config('sac', 'cartpole')
    ctrl = make('sac', functools.partial(make, env_id, device=dev, **task_cfg), training=True,
                output_dir=out_dir, seed=0, checkpoint_path='',
                **dict(algo_cfg, max_env_steps=MG_SAC_STEPS, eval_interval=0, log_interval=0,
                       save_interval=0))
    ctrl.reset()
    if mesh is not None:
        ctrl.shard_over(mesh)
    ctrl.learn()
    ag = ctrl.agent
    return dict(params=_mg_leaves(ag.full_params()), replicas=_mg_leaves(ag.train_state()),
                envs=ctrl._obs.shape[0], last=ctrl.last_results)


def _mg_rarl(dev, mesh, out_dir):
    from safe_control_gym_tpu_torch.utils.registration import make
    ctrl = make('rarl', functools.partial(make, 'cartpole', device=dev, **RARL_TASK),
                training=True, output_dir=out_dir, seed=1, checkpoint_path='',
                max_env_steps=MG_RARL_STEPS, log_interval=0, **RARL_ALGO)
    ctrl.reset()
    if mesh is not None:
        ctrl.shard_over(mesh)
    ctrl.learn()
    agents = (ctrl.agent, ctrl.adversary)
    return dict(params=[p for a in agents for p in _mg_leaves(a.params)],
                replicas=[p for a in agents for p in _mg_leaves(a.params)
                          + _mg_adam(a.actor_opt_state)], envs=ctrl._obs.shape[0],
                last=ctrl.last_results)


def _mg_solve(solver, call, rows, mesh, plans):
    """``call`` on the batch ``rows`` (arrays of MG_B rows): sharded over
    ``mesh`` with, beside it, this rank's rows solved unsharded; or, with no
    mesh, the whole batch and its answers under the two MG_PERTURB changes
    of the first array."""
    if mesh is None:
        u, ok = call(*rows)
        moved = [call(rows[0] * np.float32(1 + e), *rows[1:])[0] - u
                 for e in (MG_PERTURB, -MG_PERTURB)]
        move = np.max(np.abs(np.stack(moved)), axis=0).reshape(len(u), -1).max(axis=1)
        return dict(u=u, flags=ok, rows=plans()[0].shape[0], spread=float(move.max()),
                    spread_rows=int((move > MG_SOLVER_ATOL).sum()))
    solver.shard_over(mesh, axis_name='env')
    u, ok = call(*rows)
    local = plans()[0].shape[0]
    lo, hi = mesh.rows(len(u), 'env')
    solver._solve_mesh = None
    own_u, own_ok = call(*[r[lo:hi] for r in rows])
    return dict(u=u, flags=ok, rows=local, block=(lo, hi), own_u=own_u, own_flags=own_ok)


def _mg_certify(dev, mesh, out_dir):
    from safe_control_gym_tpu_torch.utils.registration import make
    sf = make('linear_mpsc', functools.partial(make, 'cartpole', device=dev, **CERT_DEMO_TASK),
              **dict(CERT_DEMO_SF, n_samples=4))
    sf.load(os.path.join(ROOT, 'examples', 'mpsc', 'models', 'linear_mpsc_cartpole.pkl'))
    rng = np.random.default_rng(3)
    states = rng.normal(0, 0.08, (MG_B, 4)).astype(np.float32)
    actions = rng.uniform(-1, 1, (MG_B, 1)).astype(np.float32)
    return _mg_solve(sf, sf.certify_action_batch, (states, actions), mesh,
                     lambda: sf.batch_plans)


def _mg_nmpc(dev, mesh, out_dir):
    from safe_control_gym_tpu_torch.utils.registration import make
    ctrl = make('mpc', functools.partial(make, 'cartpole', device=dev, **MPC_DEMO_TASK),
                **MPC_DEMO_ALGO)
    ctrl.reset()
    x0 = np.random.default_rng(5).uniform(-0.3, 0.3, (MG_B, 4)).astype(np.float32)
    return _mg_solve(ctrl, ctrl.select_action_batch, (x0,), mesh,
                     lambda: ctrl.batch_horizons)


def _mg_population(dev, mesh, out_dir):
    from safe_control_gym_tpu_torch.hyperparameters import population as popmod
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils.registration import make
    _, task_cfg, _ = eval_config('ppo', 'cartpole')
    world = 1 if mesh is None else mesh.shape['env']
    ev = popmod.make_population_ppo_evaluator(
        functools.partial(make, 'cartpole', **task_cfg), device=dev, mesh=mesh,
        axis_name='env', **MG_POP)
    hp = {'actor_lr': np.array([3e-4, 1e-3] * world),
          'entropy_coef': np.array([0.01, 0.02] * world)}
    return dict(returns=ev(hp, MG_POP_SEEDS * world))


def _mg_eval(dev, mesh, out_dir):
    from safe_control_gym_tpu_torch.utils.registration import make
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    env_id, task_cfg, algo_cfg = eval_config('ppo', 'cartpole')
    ctrl = make('ppo', functools.partial(make, env_id, device=dev, **task_cfg), **algo_cfg)
    ctrl.load(_model_path('ppo', 'cartpole'))
    res = ctrl.evaluate_fused(batch=MG_B, n_steps=MG_EVAL_T, seed=0, use_kernel=False if mesh
                              is None else None, mesh=mesh, return_per_env=True, n_reps=0)
    return dict(path=res['path'], reward_sum=res['per_env']['reward_sum'],
                done_count=res['per_env']['done_count'], episodes=res['episodes'])


MG_CASES = {'ppo': _mg_ppo, 'ppo_tp': functools.partial(_mg_ppo, model_axis='model'),
            'sac': _mg_sac, 'rarl': _mg_rarl, 'certify': _mg_certify, 'nmpc': _mg_nmpc,
            'population': _mg_population, 'eval': _mg_eval}


def _mg_run(names, dev, mesh, out_dir):
    """Each named case on this rank (``mesh`` None: unsharded), with its
    seconds (host clock to a synchronize) and launch counts."""
    from safe_control_gym_tpu_torch.parallel import sharding
    out = {}
    for name in names:
        case_mesh = mesh
        if mesh is not None and name == 'ppo_tp':
            case_mesh = sharding.make_dp_tp_mesh(n_model=mesh.world_size, device=dev)
        _sync(dev)
        _zero_launches()
        t0 = time.perf_counter()
        res = MG_CASES[name](dev, case_mesh, os.path.join(out_dir, name))
        _sync(dev)
        res['seconds'] = time.perf_counter() - t0
        res['launches'] = _launches()
        out[name] = res
    return out


def _mg_rank(names, out_dir):
    """A spawned rank (parallel/launch.spawn_local): its cases on an 'env'
    mesh of every rank, on this rank's CUDA device."""
    from safe_control_gym_tpu_torch.parallel import sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', torch.cuda.current_device())
    mesh = sharding.make_env_mesh(device=dev)
    return _mg_run(names, dev, mesh, os.path.join(out_dir, f'rank{mesh.rank}'))


def _mg_nccl_one(names, out_dir):
    """The cases on a world of one NCCL rank, in this process."""
    import datetime
    import torch.distributed as dist
    from safe_control_gym_tpu_torch.parallel.launch import free_port
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{free_port()}', rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=MG_TIMEOUT_S))
    try:
        return [_mg_rank(names, out_dir)]
    finally:
        dist.destroy_process_group()


def _mg_max_err(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


def _mg_check(name, ranks, ref, world):
    """The gates of case ``name`` over every rank's result against the
    one-rank ``ref``; returns the row to print."""
    r0 = ranks[0]
    row = dict(seconds=[r['seconds'] for r in ranks], ref_seconds=ref['seconds'],
               k1_launches=[r['launches']['cartpole_advance'] for r in ranks],
               ref_k1_launches=ref['launches']['cartpole_advance'])
    fails = []
    if 'params' in r0:
        err = _mg_max_err(r0['params'], ref['params'])
        # Data parallel: every rank's parameters and Adam states are one
        # replica. dp x tp on (1, W): the ranks' gathered parameters.
        key = 'params' if name == 'ppo_tp' else 'replicas'
        same = all(len(r[key]) == len(r0[key]) and all(
            np.array_equal(x, y) for x, y in zip(r[key], r0[key])) for r in ranks)
        row.update(params_max_abs_err=err, replicas_identical=same,
                   envs=[r['envs'] for r in ranks], atol=MG_PARAMS_ATOL)
        if not err <= MG_PARAMS_ATOL or not same:
            fails.append('params')
        if name == 'ppo_tp':
            # (1, W) mesh: every rank steps all envs and holds 1/W of the
            # hidden layers (the first layer's columns).
            split = [r['shards'][1].shape for r in ranks]
            row['first_layer_shards'] = [list(t) for t in split]
            if world > 1 and (any(t != (4, 64 // world) for t in split) or np.array_equal(
                    ranks[0]['shards'][1], ranks[-1]['shards'][1])):
                fails.append('tp split')
        # Every rank steps its envs once a step: as many K1 launches as the
        # one-rank run, each over its envs.
        want = row['ref_k1_launches']
        if want <= 0 or any(n != want for n in row['k1_launches']):
            fails.append('k1 launches')
    if 'flags' in r0:
        # Each rank's block of the gathered answer against that rank's
        # unsharded solve of the same rows; the flags against the whole
        # batch's on one rank.
        block_err = max(_mg_max_err(r0['u'][r['block'][0]:r['block'][1]], r['own_u'])
                        for r in ranks)
        whole = np.abs(np.asarray(r0['u'], np.float64) - np.asarray(ref['u'], np.float64))
        whole = whole.reshape(len(whole), -1).max(axis=1)
        row.update(u_block_max_abs_err=block_err, atol=MG_SOLVER_ATOL,
                   flags_equal=bool(all(np.array_equal(r['flags'], ref['flags'])
                                        and np.array_equal(r['flags'], r0['flags'])
                                        and np.array_equal(r0['flags'][r['block'][0]:r['block'][1]],
                                                           r['own_flags']) for r in ranks)),
                   rows_a_rank=[r['rows'] for r in ranks],
                   feasible_share=float(np.mean(ref['flags'])),
                   whole_batch_u_max_abs_err=float(whole.max()),
                   whole_batch_rows_over_atol=int((whole > MG_SOLVER_ATOL).sum()),
                   one_rank_perturbed_spread=ref['spread'],
                   one_rank_perturbed_rows_over_atol=ref['spread_rows'],
                   ranks_agree=all(np.array_equal(r['u'], r0['u']) for r in ranks))
        if (not block_err <= MG_SOLVER_ATOL or not row['flags_equal'] or not row['ranks_agree']
                or any(r['rows'] != MG_B // world for r in ranks)):
            fails.append('solver')
    if name == 'population':
        got, want = r0['returns'], ref['returns']
        # Lanes [a, b] a rank: every rank's pair against the one-rank pair.
        err = max(_mg_max_err(got[2 * i:2 * i + 2], want) for i in range(world))
        row.update(lanes=int(got.shape[0]), returns_max_abs_err=err, atol=MG_POP_ATOL,
                   ranks_agree=all(np.array_equal(r['returns'], got) for r in ranks))
        if not err <= MG_POP_ATOL or not row['ranks_agree'] or any(
                n != row['ref_k1_launches'] for n in row['k1_launches']):
            fails.append('population')
    if name == 'eval':
        err = _mg_max_err(r0['reward_sum'], ref['reward_sum'])
        row.update(path=r0['path'], reward_sum_max_abs_err=err, atol=MG_EVAL_ATOL,
                   done_counts_equal=bool(all(np.array_equal(r['done_count'], ref['done_count'])
                                              for r in ranks)), episodes=r0['episodes'])
        if (r0['path'] != 'per-step-scan-sharded' or not err <= MG_EVAL_ATOL
                or not row['done_counts_equal']
                or any(n != MG_EVAL_T for n in row['k1_launches'])):
            fails.append('eval')
    row['fails'] = fails
    return row


def multigpu(dev, smi):
    """Phase multigpu: the sharded paths on one NCCL rank and on two gloo
    ranks sharing the card, each case against one unsharded rank; see the
    module docstring."""
    from safe_control_gym_tpu_torch.parallel.launch import spawn_local
    one = [n for n in MG_CASES if n != 'ppo_tp']
    rows, failed = {}, []
    with tempfile.TemporaryDirectory() as out_dir:
        with ThreadPoolExecutor(len(MG_GLOO_GROUPS)) as pool:
            # The gloo ranks start (about 8 s each to reach the card) while
            # this process runs the references and the NCCL rank.
            t0 = time.perf_counter()
            gloo = [pool.submit(spawn_local, _mg_rank, MG_WORLD, backend='gloo',
                                devices=['cuda:0'] * MG_WORLD,
                                args=(names, os.path.join(out_dir, f'gloo{i}')),
                                timeout=MG_TIMEOUT_S)
                    for i, names in enumerate(MG_GLOO_GROUPS)]
            ref = _mg_run([n for n in MG_CASES if n != 'ppo_tp'], dev, None,
                          os.path.join(out_dir, 'ref'))
            ref['ppo_tp'] = ref['ppo']      # the same unsharded call
            nccl = _mg_nccl_one(one, os.path.join(out_dir, 'nccl'))
            # Each rank's results of both worlds, by case.
            gloo = [dict(kv for g in groups for kv in g.items())
                    for groups in zip(*[f.result() for f in gloo])]
            wall = time.perf_counter() - t0
    for label, world, results in (('nccl', 1, nccl), ('gloo', MG_WORLD, gloo)):
        for name in results[0]:
            row = _mg_check(name, [r[name] for r in results], ref[name], world)
            row.update(backend=label, world_size=world, device='cuda:0', card=smi,
                       witness='correctness, not scaling: every rank shares one card')
            rows[f'{label} {name}'] = row
            emit('multigpu', case=name, **row)
            if row['fails']:
                failed.append(f'{label} {name}: {row["fails"]}')
    # Each kernel's launches on the two gloo ranks, over every case.
    launches = {k: sum(r[n]['launches'][k] for r in gloo for n in r)
                for k in gloo[0]['ppo']['launches']}
    emit('multigpu', wall_s=wall, launches=launches, card=smi)
    if failed:
        raise RuntimeError(f'multigpu: {failed}')
    return launches, rows


# ---------------------------------------------------------------------------
# Phase examples: the entry points of safe_control_gym_tpu_torch/examples.
EX_STEPS = 10            # the experiments' loops, cut as the JAX package's tests cut them
EX_B = 256               # the batched demos and the sharded sweep (one NCCL rank)
EX_CPU_ROWS = 8          # batch rows held to the port's CPU solve of them
EX_ILQR_CPU_ROWS = 4
EX_SCENARIOS = 8
EX_SCENARIO_SEC = 1      # the scenario demo's episodes, 15 steps each (6 s in the demo)
EX_EVAL = (4096, 250)    # fused_eval_demo's batch and steps
EX_DIFF = (10, 2)        # differentiable_sim_demo's T and iterations (60 and 500 in the demo)
EX_HPO = ['algo_config.max_env_steps=1600', 'hpo_config.trials=1',
          "hpo_config.hps_config={'actor_lr': 1, 'critic_lr': 1, 'entropy_coef': 1}"]
EX_TRAIN = ['algo_config.max_env_steps=1200', 'algo_config.rollout_batch_size=8']
EX_OFF_GOAL = "task_config.init_state={'init_x': 0.1, 'init_theta': 0.05}"


def _ex_yaml(directory, system, *names):
    return [os.path.join(ROOT, 'examples', directory, 'config_overrides', system, n)
            for n in names]


# The experiment cells: (module under safe_control_gym_tpu_torch.examples, its
# command line, run()'s arguments, the physics kernel its loops step, its env
# steps). randomized_init is off: the card's generator and the CPU's draw
# other initial states (tests/test_torch_examples.py runs the same cells
# against the JAX package).
EX_EXPERIMENTS = {
    'verbose_api': ('no_controller.verbose_api', [
        '--task', 'cartpole', '--overrides',
        os.path.join(ROOT, 'examples', 'no_controller', 'config_overrides',
                     'verbose_api_cartpole.yaml'),
        '--kv_overrides', 'task_config.randomized_init=False'], {}, 'cartpole_advance', 1),
    'lqr_experiment': ('lqr.lqr_experiment', [
        '--algo', 'lqr', '--task', 'cartpole', '--overrides',
        *_ex_yaml('lqr', 'cartpole', 'cartpole_stab.yaml', 'lqr_cartpole_stab.yaml'),
        '--kv_overrides', 'task_config.randomized_init=False'],
        dict(n_episodes=None, n_steps=EX_STEPS), 'cartpole_advance', EX_STEPS),
    'pid_experiment': ('pid.pid_experiment', [
        '--algo', 'pid', '--task', 'quadrotor', '--overrides',
        *_ex_yaml('pid', 'quadrotor_3D', 'quadrotor_3D_track.yaml',
                  'pid_quadrotor_3D_track.yaml'),
        '--kv_overrides', 'task_config.task_info.trajectory_type=custom'],
        dict(n_episodes=None, n_steps=EX_STEPS), 'quad3d_advance', EX_STEPS),
    'mpc_experiment': ('mpc.mpc_experiment', [
        '--algo', 'linear_mpc', '--task', 'cartpole', '--overrides',
        *_ex_yaml('mpc', 'cartpole', 'cartpole_stab.yaml', 'linear_mpc_cartpole_stab.yaml'),
        '--kv_overrides', 'algo_config.horizon=10'],
        dict(n_episodes=None, n_steps=EX_STEPS), 'cartpole_advance', EX_STEPS),
    'rl_experiment': ('rl.rl_experiment', [
        '--algo', 'sac', '--task', 'quadrotor', '--overrides',
        *_ex_yaml('rl', 'quadrotor_2D', 'quadrotor_2D_stab.yaml', 'sac_quadrotor_2D.yaml'),
        '--kv_overrides', 'algo_config.training=False', 'task_config.randomized_init=False'],
        dict(n_episodes=None, n_steps=EX_STEPS), 'quad2d_advance', EX_STEPS),
    'mpsc_experiment': ('mpsc.mpsc_experiment', [
        '--task', 'cartpole', '--algo', 'lqr', '--safety_filter', 'linear_mpsc', '--overrides',
        *_ex_yaml('mpsc', 'cartpole', 'cartpole_stab.yaml', 'lqr_cartpole.yaml',
                  'linear_mpsc_cartpole.yaml'),
        '--kv_overrides', 'sf_config.cost_function=one_step_cost'],
        dict(training=False, n_episodes=None, n_steps=5), 'cartpole_advance', 10),
    'cbf_experiment': ('cbf.cbf_experiment', [
        '--algo', 'lqr', '--task', 'cartpole', '--safety_filter', 'cbf', '--overrides',
        *_ex_yaml('cbf', 'cartpole', 'cartpole_stab.yaml', 'lqr_cartpole_stab.yaml',
                  'cbf_cartpole_stab.yaml'),
        '--kv_overrides', 'task_config.randomized_init=False', EX_OFF_GOAL],
        dict(training=False, n_episodes=None, n_steps=EX_STEPS), 'cartpole_advance', EX_STEPS),
}


@contextlib.contextmanager
def _argv(args):
    """``sys.argv`` for an entry point that reads its command line."""
    saved = sys.argv
    sys.argv = ['example'] + list(args)
    try:
        yield
    finally:
        sys.argv = saved


def _ex_numbers(out):
    """An entry point's result as flat numpy: every metric (or printed array),
    and of a run's records the actions, observations, rewards and the safety
    filter's corrections (not its timestamps or infos)."""
    flat = {}
    parts = out if isinstance(out, tuple) else (out,)
    for i, part in enumerate(parts):
        records = isinstance(part.get('action'), list)
        for key, value in part.items():
            if records and key in ('action', 'obs', 'reward'):
                value = np.concatenate([np.asarray(v, np.float64).reshape(len(v), -1)
                                        for v in value])
            elif records and key == 'safety_filter_data':
                value = np.concatenate([np.asarray(c, np.float64).ravel()
                                        for c in value['correction']])
            elif records:
                continue
            flat[f'{i}.{key}'] = np.asarray(value, np.float64)
    return flat


def _ex_experiment(name, device):
    """One experiment cell through its entry point on ``device``: its numbers."""
    import importlib
    module, args, kwargs, _, _ = EX_EXPERIMENTS[name]
    mod = importlib.import_module(f'safe_control_gym_tpu_torch.examples.{module}')
    with _argv(args + ['--device', str(device)]):
        return _ex_numbers(mod.run(**kwargs))


def _ex_sweep_solvers(device):
    """sharded_sweep_demo's NMPC and filter on ``device``, the filter with
    the committed RPI set (phase safety runs learn() on the card)."""
    from safe_control_gym_tpu_torch.examples.mpc import sharded_sweep_demo as demo
    from safe_control_gym_tpu_torch.utils.registration import make
    env_func = functools.partial(make, 'cartpole', device=device, **demo.CFG)
    ctrl = make('mpc', env_func, **demo.NMPC)
    ctrl.reset()
    sf = make('linear_mpsc', env_func, **demo.MPSC)
    sf.load(os.path.join(ROOT, 'examples', 'mpsc', 'models', 'linear_mpsc_cartpole.pkl'))
    return ctrl, sf


def _ex_batch_inputs(kind):
    """A batched demo's B inputs: states, and the actions to certify."""
    from safe_control_gym_tpu_torch.examples.mpc import sharded_sweep_demo
    from safe_control_gym_tpu_torch.examples.mpsc import batched_certification_demo
    if kind == 'certification':
        return batched_certification_demo.demo_inputs(EX_B)
    if kind in ('nmpc', 'sweep certification'):
        return sharded_sweep_demo.sweep_inputs(EX_B)
    return np.random.default_rng(0).uniform(-0.3, 0.3, (EX_B, 4)).astype(np.float32), None


def _ex_cpu_rows(kind):
    """The CPU's answers (actions, flags) to a batched demo's first
    EX_CPU_ROWS problems, and to each one's SAFETY_PERTURBED changed states
    (the row's action kept): (actions, flags, variants (rows, n, nu))."""
    states, actions = _ex_batch_inputs(kind)
    if kind == 'batched_mpc_demo':
        from safe_control_gym_tpu_torch.examples.mpc import batched_mpc_demo
        _, solve = batched_mpc_demo.build_batched_solver(device='cpu')
        fn = lambda s, a: (lambda u, res: (u.numpy(), res.numpy() < 1e-2))(*solve(s))
    elif kind == 'batched_gp_mpc_demo':
        from safe_control_gym_tpu_torch.examples.mpc import batched_gp_mpc_demo
        gp = batched_gp_mpc_demo.build_controller(device='cpu')
        fn = lambda s, a: gp.select_action_batch(s)
    elif kind == 'nmpc':
        ctrl, _ = _ex_sweep_solvers('cpu')
        fn = lambda s, a: ctrl.select_action_batch(s)
    else:
        _, sf = _ex_sweep_solvers('cpu')
        fn = sf.certify_action_batch
    n, k = EX_CPU_ROWS, SAFETY_PERTURBED
    out = fn(states[:n], None if actions is None else actions[:n])
    changed = np.concatenate([_perturbed(states[i]) for i in range(n)])
    moved = fn(changed, None if actions is None else np.repeat(actions[:n], k, axis=0))
    return out[0], out[1], moved[0].reshape(n, k, -1), out[2:]


def _ex_cpu_worker(task, *args):
    """A CPU reference in a worker process (one torch thread)."""
    torch.set_num_threads(1)
    if task == 'experiments':
        return {name: _ex_experiment(name, 'cpu') for name in args[0]}
    if task == 'rows':
        return _ex_cpu_rows(args[0])
    if task == 'ilqr':
        from safe_control_gym_tpu_torch.examples.lqr import batched_ilqr_demo
        return batched_ilqr_demo.main(B=EX_ILQR_CPU_ROWS, device='cpu')
    if task == 'scenario':
        from safe_control_gym_tpu_torch.examples.mpc import scenario_mpc_demo as demo
        demo.TASK = dict(demo.TASK, episode_len_sec=EX_SCENARIO_SEC)
        return demo.run(n_scenarios=EX_SCENARIOS, verbose=False, device='cpu')
    if task == 'diff':
        from safe_control_gym_tpu_torch.examples import differentiable_sim_demo
        _, cost_and_grad = differentiable_sim_demo.build(EX_DIFF[0], 'cpu')
        return float(cost_and_grad(torch.zeros((EX_DIFF[0], 1)))[0])
    if task == 'hpo':
        from safe_control_gym_tpu_torch.examples.hpo import hpo_experiment
        with _argv(args[0]):
            return [t['params'] for t in hpo_experiment.run().trials]
    raise ValueError(task)


def _ex_expect(label, moved, want):
    """Each kernel's launches exactly ``want``'s (0 where it names none)."""
    wrong = {k: v for k, v in moved.items() if v != want.get(k, 0)}
    if wrong:
        raise RuntimeError(f'examples {label}: launches {moved}, expected {want}')


def _ex_close(label, got, want, atol):
    """Every number of ``got`` within ``atol`` (absolute and relative) of
    ``want``'s, the same keys; the largest error."""
    if set(got) != set(want):
        raise RuntimeError(f'examples {label}: keys {sorted(got)} against {sorted(want)}')
    err = 0.0
    for key in want:
        a, b = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        if a.shape != b.shape or not np.allclose(a, b, rtol=atol, atol=atol):
            raise RuntimeError(f'examples {label}: {key} {a} against the CPU\'s {b}')
        err = max(err, float(np.max(np.abs(a - b), initial=0.0)))
    return err


def _ex_rows(label, card_u, card_f, cpu, atol):
    """The first rows of a card batch against the CPU's solve of them
    (``_ex_cpu_rows``' result): flags equal; each action within ``atol``,
    or, where the CPU's own answer moves by more under 1e-7 changes of its
    state, one of its answers within it (phase safety's ``_agree``)."""
    cpu_u, cpu_f, variants = cpu[:3]
    n = cpu_u.shape[0]
    err = np.abs(np.asarray(card_u[:n], np.float64) - cpu_u).reshape(n, -1).max(axis=1)
    moved = [dict(row=int(i), card_err=float(err[i]),
                  **_agree(card_u[i], cpu_u[i], list(variants[i])))
             for i in np.flatnonzero(err > atol)]
    row = dict(rows=n, action_max_abs_err=float(err.max()), rows_beyond_atol=moved,
               flags_equal=bool(np.array_equal(np.asarray(card_f)[:n], cpu_f)))
    if not row['flags_equal'] or not all(m['ok'] for m in moved):
        raise RuntimeError(f'examples {label}: the card differs from the CPU: {row}')
    return row


def examples(dev, smi):
    """Phase examples: one cell of each entry point of
    safe_control_gym_tpu_torch/examples on the card, each held to the same
    cell on the port's CPU (computed in worker processes meanwhile); see the
    module docstring."""
    from safe_control_gym_tpu_torch.examples import differentiable_sim_demo, generate_pretrained
    from safe_control_gym_tpu_torch.examples.hpo import hpo_experiment
    from safe_control_gym_tpu_torch.examples.lqr import batched_ilqr_demo
    from safe_control_gym_tpu_torch.examples.mpc import (batched_gp_mpc_demo, batched_mpc_demo,
                                                         scenario_mpc_demo, sharded_sweep_demo)
    from safe_control_gym_tpu_torch.examples.mpsc import batched_certification_demo
    from safe_control_gym_tpu_torch.examples.rl import fused_eval_demo, rl_experiment, train_rl
    t_phase = time.perf_counter()
    rows, seconds, total = {}, {}, {}

    def cell(name, want, fn, *args, **kwargs):
        """``fn`` on the card, timed, its launches held to ``want``."""
        before = _policy_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        moved = {k: v - before[k] for k, v in _policy_counts().items()}
        for k, v in moved.items():
            total[k] = total.get(k, 0) + v
        emit('examples', part=name, seconds=seconds[name], launches=moved)
        _ex_expect(name, moved, want)
        return out, moved

    hpo_args = (['--algo', 'ppo', '--task', 'cartpole', '--overrides']
                + [os.path.join(ROOT, p) for p in EXP_HPO_OVERRIDES] + ['--kv_overrides']
                + EX_HPO)
    batches = ('batched_mpc_demo', 'batched_gp_mpc_demo', 'certification', 'nmpc',
               'sweep certification')
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            max_workers=4, mp_context=multiprocessing.get_context('spawn')) as pool:
        cpu = {'experiments': pool.submit(_ex_cpu_worker, 'experiments', list(EX_EXPERIMENTS)),
               'hpo': pool.submit(_ex_cpu_worker, 'hpo', hpo_args + [
                   '--device', 'cpu', '--output_dir', os.path.join(tmp, 'hpo_cpu')]),
               'ilqr': pool.submit(_ex_cpu_worker, 'ilqr'),
               **{kind: pool.submit(_ex_cpu_worker, 'rows', kind) for kind in batches},
               'scenario': pool.submit(_ex_cpu_worker, 'scenario'),
               'diff': pool.submit(_ex_cpu_worker, 'diff')}
        # The experiments.
        card_exp = {}
        for name, (_, _, _, kname, steps) in EX_EXPERIMENTS.items():
            card_exp[name], moved = cell(name, {kname: steps}, _ex_experiment, name, dev)
            rows[name] = dict(steps=steps, launches=moved)
        # Batched iLQR: two solves of T=45 x 10 iterations.
        ilqr, _ = cell('batched_ilqr_demo', {'cartpole_advance': 2 * 10 * 45},
                       batched_ilqr_demo.main, B=EX_B, device=dev)
        # Batched MPC: no env step.
        (mpc_u, mpc_res), _ = cell('batched_mpc_demo', {}, batched_mpc_demo.main,
                                   [str(EX_B), '--device', str(dev)])
        # Batched GP-MPC: learn() (60 samples), then two batches of 2 passes.
        (gp_u, gp_feas, gp_binds), _ = cell('batched_gp_mpc_demo', {'cartpole_advance': 60},
                                            batched_gp_mpc_demo.main,
                                            [str(EX_B), '--device', str(dev)])
        # The scenario demo on short episodes: 2 x 15 steps.
        saved_task = scenario_mpc_demo.TASK
        scenario_mpc_demo.TASK = dict(saved_task, episode_len_sec=EX_SCENARIO_SEC)
        try:
            scen, _ = cell('scenario_mpc_demo', {'cartpole_advance': 2 * 15 * EX_SCENARIO_SEC},
                           scenario_mpc_demo.run, n_scenarios=EX_SCENARIOS, verbose=False,
                           device=dev)
        finally:
            scenario_mpc_demo.TASK = saved_task
        # The sweep's solvers; the certification demo on that warm filter, then
        # the sweep on one NCCL rank.
        (ctrl, sf), _ = cell('sharded_sweep_demo', {}, _ex_sweep_solvers, dev)
        (cert, ok), _ = cell('batched_certification_demo', {},
                             batched_certification_demo.certify, sf, EX_B, dev)
        sweep, _ = cell('sharded_sweep_demo', {}, sharded_sweep_demo.one_nccl_rank, EX_B,
                        solvers=(ctrl, sf))
        # The fleet evaluation: K4 in policy mode, a warm-up and a timed launch.
        res, _ = cell('fused_eval_demo', {'cartpole_rollout': 2, 'cartpole_rollout.policy': 2},
                      fused_eval_demo.main, [str(EX_EVAL[0]), str(EX_EVAL[1]), '--device',
                                             str(dev)])
        rows['fused_eval_demo'] = dict(path=res['path'], episodes=res['episodes'],
                                       ep_length_mean=res['ep_length_mean'],
                                       ep_return_mean=res['ep_return_mean'],
                                       steps_per_sec=res['steps_per_sec'])
        if not (res['ep_length_mean'] > 150
                and res['ep_return_mean'] > 0.7 * res['ep_length_mean']):
            raise RuntimeError(f'examples fused_eval_demo: {rows["fused_eval_demo"]}')
        # The differentiable simulation: T steps a cost, iterations + 2 costs
        # (phase mpc holds the demo's gradient to the CPU's).
        T, iters = EX_DIFF
        (c0, c1), _ = cell('differentiable_sim_demo', {'cartpole_advance': (iters + 2) * T},
                           differentiable_sim_demo.main, T=T, iters=iters, device=dev)
        # HPO: one trial of one iteration of 16 x 100 and its 251-step eval.
        with _argv(hpo_args + ['--device', str(dev), '--output_dir', os.path.join(tmp, 'hpo')]):
            study, _ = cell('hpo_experiment', {'cartpole_advance': 100 + 251},
                            hpo_experiment.run)
        # train_rl (one iteration of 8 x 150), then generate_pretrained's
        # ppo_cartpole_stab (one iteration of 64 x 150); rl_experiment loads
        # each model back, on the card and on the CPU.
        train_args = (['--algo', 'ppo', '--task', 'cartpole', '--overrides',
                       *_ex_yaml('rl', 'cartpole', 'cartpole_stab.yaml', 'ppo_cartpole.yaml'),
                       '--output_dir', os.path.join(tmp, 'train'), '--kv_overrides']
                      + EX_TRAIN)
        with _argv(train_args + ['--device', str(dev)]):
            path, _ = cell('train_rl', {'cartpole_advance': 150}, train_rl.run,
                           curr_path=os.path.join(tmp, 'train'))
        paths, _ = cell('generate_pretrained', {'cartpole_advance': 150}, generate_pretrained.main,
                        ['--only', 'ppo_cartpole_stab', '--steps', '1', '--out_dir',
                         os.path.join(tmp, 'pretrained'), '--device', str(dev)])
        eval_args = ['--algo', 'ppo', '--task', 'cartpole', '--overrides',
                     *_ex_yaml('rl', 'cartpole', 'cartpole_stab.yaml', 'ppo_cartpole.yaml'),
                     '--kv_overrides', 'algo_config.training=False',
                     'task_config.randomized_init=False', EX_OFF_GOAL]
        for label, model, curr in (('train_rl', path, os.path.join(tmp, 'train')),
                                   ('generate_pretrained', paths['ppo_cartpole_stab'],
                                    os.path.join(tmp, 'pretrained', 'rl'))):
            run = functools.partial(rl_experiment.run, n_episodes=None, n_steps=EX_STEPS,
                                    curr_path=curr)
            with _argv(eval_args + ['--device', str(dev)]):
                card_run, _ = cell('rl_experiment', {'cartpole_advance': EX_STEPS}, run)
            with _argv(eval_args + ['--device', 'cpu']):
                cpu_run = run()
            rows[label] = dict(path=os.path.relpath(model, tmp), rl_experiment_max_abs_err=(
                _ex_close(f'{label} -> rl_experiment', _ex_numbers(card_run),
                          _ex_numbers(cpu_run), CONTROL_ATOL)))

        # The CPU's references.
        cpu_exp = cpu['experiments'].result()
        for name in EX_EXPERIMENTS:
            rows[name]['max_abs_err'] = _ex_close(name, card_exp[name], cpu_exp[name],
                                                  CONTROL_ATOL)
        ilqr_h, r = cpu['ilqr'].result(), EX_ILQR_CPU_ROWS
        rows['batched_ilqr_demo'] = dict(B=EX_B, converged=int(ilqr['converged'].sum()),
                                         cost=ilqr['cost'][:r].tolist(),
                                         cpu_cost=ilqr_h['cost'].tolist())
        if not (np.allclose(ilqr['cost'][:r], ilqr_h['cost'], rtol=CONTROL_RTOL)
                and np.array_equal(ilqr['converged'][:r], ilqr_h['converged'])
                and np.array_equal(ilqr['iterations'][:r], ilqr_h['iterations'])):
            raise RuntimeError(f'examples batched_ilqr_demo: {rows["batched_ilqr_demo"]}')
        rows['batched_mpc_demo'] = dict(B=EX_B, converged=int((mpc_res < 1e-2).sum()), **_ex_rows(
            'batched_mpc_demo', mpc_u, mpc_res < 1e-2, cpu['batched_mpc_demo'].result(),
            MPC_ATOL))
        gp_h = cpu['batched_gp_mpc_demo'].result()
        rows['batched_gp_mpc_demo'] = dict(
            B=EX_B, feasible=int(gp_feas.sum()), capped=int((gp_binds > 0).sum()),
            binds_equal=bool(np.array_equal(gp_binds[:EX_CPU_ROWS], gp_h[3][0])),
            **_ex_rows('batched_gp_mpc_demo', gp_u, gp_feas, gp_h, GP_ATOL))
        if not rows['batched_gp_mpc_demo']['binds_equal']:
            raise RuntimeError(f'examples batched_gp_mpc_demo: {rows["batched_gp_mpc_demo"]}')
        scen_h = cpu['scenario'].result()
        rows['scenario_mpc_demo'] = dict(cost_nominal=scen[0], cost_scenario=scen[1],
                                         identified_pole_length=scen[2], cpu=scen_h)
        if not (np.allclose(scen[:2], scen_h[:2], rtol=MPC_COST_RTOL) and scen[2] == scen_h[2]
                and scen[1] < scen[0]):
            raise RuntimeError(f'examples scenario_mpc_demo: {rows["scenario_mpc_demo"]}')
        rows['batched_certification_demo'] = dict(
            B=EX_B, feasible=int(ok.sum()), filter='the sharded sweep\'s (the committed P)',
            **_ex_rows('batched_certification_demo', cert, ok, cpu['certification'].result(),
                       SAFETY_ATOL))
        rows['sharded_sweep_demo'] = dict(
            B=EX_B, world=sweep['world'], backend='nccl', nmpc_seconds=sweep['nmpc_seconds'],
            cert_seconds=sweep['cert_seconds'], nmpc_feasible=int(sweep['feasible'].sum()),
            cert_feasible=int(sweep['cert_feasible'].sum()),
            nmpc=_ex_rows('sharded_sweep_demo nmpc', sweep['u'], sweep['feasible'],
                          cpu['nmpc'].result(), MPC_ATOL),
            certification=_ex_rows('sharded_sweep_demo certification', sweep['certified'],
                                   sweep['cert_feasible'], cpu['sweep certification'].result(),
                                   SAFETY_ATOL))
        cost_h = cpu['diff'].result()
        rows['differentiable_sim_demo'] = dict(T=T, iterations=iters, cost_first=c0,
                                               cost_last=c1, cost_cpu=cost_h)
        if not (abs(c0 - cost_h) <= GRAD_RTOL * abs(cost_h) and c1 < c0):
            raise RuntimeError(f'examples differentiable_sim_demo: '
                               f'{rows["differentiable_sim_demo"]}')
        params_h = cpu['hpo'].result()
        rows['hpo_experiment'] = dict(trials=len(study.trials),
                                      values=[t['value'] for t in study.trials],
                                      params_equal=[t['params'] for t in study.trials] == params_h)
        if not (rows['hpo_experiment']['params_equal']
                and all(np.isfinite(rows['hpo_experiment']['values']))):
            raise RuntimeError(f'examples hpo_experiment: {rows["hpo_experiment"]}')
    for name, row in rows.items():
        emit('examples', entry_point=name, seconds=seconds.get(name), card=smi, **row)
    emit('examples', seconds_by_entry_point=seconds, launches=total,
         seconds=time.perf_counter() - t_phase, card=smi)
    return total, rows


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the GPU', file=sys.stderr)
        sys.exit(2)
    only = sys.argv[sys.argv.index('--phase') + 1] if '--phase' in sys.argv else None
    from safe_control_gym_tpu_torch.ops import _build
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    name = torch.cuda.get_device_name(0)
    emit('card', nvidia_smi=smi, device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit('build', seconds=time.perf_counter() - t0, flags=_build.NVCC_FLAGS,
         libraries=sorted(libs))
    seconds = {'import': t_start - _T_START, 'build': time.perf_counter() - t0}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t0
        emit('seconds', of_phase=phase, seconds=seconds[phase])
        return out
    if only is not None:
        # Some phases alone (a development run): their lines, and no result.
        for phase in only.split(','):
            timed(phase, {'control': control, 'mpc': mpc, 'gp_mpc': gp_mpc,
                          'safety': safety, 'off_policy': off_policy,
                          'robust': robust, 'experiment': experiment,
                          'env_extras': env_extras, 'multigpu': multigpu,
                          'examples': examples}[phase], dev, smi)
        emit('done', wall_seconds=time.perf_counter() - _T_START, seconds_by_phase=seconds,
             card=smi, phases=only)
        return
    physics = timed('k1-k3', lambda: {s: check_physics(s, dev) for s in SYSTEMS})
    rollout = timed('k4-k5', lambda: {s: check_rollout(s, dev) for s in SYSTEMS})
    serial = timed('chain', chain, dev)
    launches, rows = timed('main_path', main_path, dev, smi)
    timed('welch', welch, dev)
    policy = timed('k4_policy-k5_policy', lambda: {s: check_policy(s, dev) for s in SYSTEMS})
    cl_launches, cl_rows = timed('closed_loop', closed_loop, dev, smi)
    timed('welch_closed_loop', welch_closed_loop, dev)
    train = timed('ppo_train', ppo_train, dev, smi)
    ctl_launches, ctl_rows = timed('control', control, dev, smi)
    mpc_launches, mpc_rows = timed('mpc', mpc, dev, smi)
    gp_launches, gp_rows = timed('gp_mpc', gp_mpc, dev, smi)
    sf_launches, sf_rows = timed('safety', safety, dev, smi)
    op_launches, op_rows = timed('off_policy', off_policy, dev, smi)
    rb_launches, rb_rows = timed('robust', robust, dev, smi)
    ex_launches, ex_rows = timed('experiment', experiment, dev, smi)
    xt_launches, _ = timed('env_extras', env_extras, dev, smi)
    mg_launches, _ = timed('multigpu', multigpu, dev, smi)
    eg_launches, eg_rows = timed('examples', examples, dev, smi)
    train_rows = {'cartpole': train['cartpole'], 'quadrotor': train['quadrotor_2D'],
                  'quadrotor_3D': train['quadrotor_3D']}
    for system in SYSTEMS:
        row = policy[system]
        row['launches'] = cl_launches[f'{ROLLOUT[system]["name"]}.policy']
        bench = cl_rows[f'bench {system} hidden=64']
        row['main_path_ms'] = bench['kernel_ms']
        row['main_path_shape'] = f'B={B} T={bench["T"]} stochastic, actor hidden 64'
        kw = dict(draw_actions=False, randomized_reset=False, policy_stochastic=True,
                  policy_params=rk.PolicyParams(None, NX[system], 64, 64, NU[system]))
        row['main_path_bound_ms'] = bound_ms(
            policy_rollout_bytes(system, kw, bench['T']),
            policy_rollout_ops(system, kw, bench['T'], bench['mean_done_count'] * B))[0]
        if system == 'cartpole':
            row['off_policy_launches'] = op_launches['cartpole_rollout.policy']
            row['off_policy_shape'] = (
                f'evaluate_fused B={B} T={T_OFF_POLICY_EVAL} of the SAC and DDPG actors '
                f'trained in phase off_policy ({op_rows["sac k4"]["actor"]}, '
                f'{op_rows["ddpg k4"]["actor"]}); each held to the plain version over '
                f'{T_OFF_POLICY_CHECK} steps (state errors {op_rows["sac k4"]["state_err"]}, '
                f'{op_rows["ddpg k4"]["state_err"]})')
            row['examples_launches'] = eg_launches['cartpole_rollout.policy']
            row['examples_shape'] = (f'fused_eval_demo: the committed PPO model, B={EX_EVAL[0]} '
                                     f'T={EX_EVAL[1]}, a warm-up and a timed launch')
    cycles_ms = lambda cycles: cycles / (serial['clock_ghz'] * 1e6)
    for system in SYSTEMS:
        # The per-step kernel's chain bound: n_substeps x one substep's
        # loop-carried chain at the latencies and SM clock of this run. Its
        # issue floor: n_substeps x one substep's fast-path instructions (the
        # instantiation for N_SUB) at one a cycle, what one warp an SM
        # (B=4096) issues at best.
        row = physics[system]
        row['launches'] = launches[PHYSICS[system]['name']]
        tr = train_rows[system]
        row['train_launches'] = tr['launches'][PHYSICS[system]['name']]
        row['train_shape'] = (f'B={tr["envs"]} T={tr["T"]} x {tr["iterations"]} PPO '
                              'iterations' + (' + 10-episode eval' if system == 'cartpole'
                                              else ''))
        row['control_launches'] = ctl_launches[PHYSICS[system]['name']]
        row['control_shape'] = {
            'cartpole': (f'iLQR solve_batch B={B_CONTROL} T={ctl_rows["ilqr cartpole"]["T"]} '
                         f'x 10 iterations, 50 substeps + LQR closed loop B=1 '
                         f'({ctl_rows["lqr cartpole"]["steps"]} steps)'),
            'quadrotor': (f'iLQR solve_batch B={B_CONTROL} T={ctl_rows["ilqr quadrotor_2D"]["T"]}'
                          ' x 10 iterations, 4 substeps'),
            'quadrotor_3D': (f'PID closed loop B=1 ({ctl_rows["pid quadrotor_3D"]["steps"]} '
                             'steps, 20 substeps)')}[system]
        row['mpc_launches'] = mpc_launches[PHYSICS[system]['name']]
        row['mpc_shape'] = {
            'cartpole': (f'MPC ({mpc_rows["mpc"]["steps"]} steps, 3 SQP) and MPC_ACADOS RTI '
                         f'({mpc_rows["mpc_acados"]["steps"]} steps) closed loops B=1, '
                         '50 substeps, horizon 20'),
            'quadrotor': (f'linear MPC closed loop B=1 ({mpc_rows["linear_mpc"]["steps"]} '
                          'steps, 20 substeps, horizon 20)'),
            'quadrotor_3D': 'not on the MPC path'}[system]
        row['grad_max_abs_err'] = mpc_rows['gradient'][PHYSICS[system]['id']]['max_abs_err']
        row['gp_mpc_launches'] = gp_launches[PHYSICS[system]['name']]
        gc, gq = gp_rows['cartpole'], gp_rows['quadrotor_2D']
        row['gp_mpc_shape'] = {
            'cartpole': (f'B=1, 50 substeps: gp_mpc_cartpole_stab learn() '
                         f'({gc["learn_samples"]} samples) and loop ({gc["steps"]} steps), online '
                         f'loop ({gp_rows["online"]["steps"]} steps), batched_gp_mpc_demo learn() '
                         f'({gp_rows["batch"]["learn_samples"]} samples), scenario loop '
                         f'({gp_rows["scenarios"]["steps"]} steps)'),
            'quadrotor': (f'B=1, 8 substeps: learn() ({gq["learn_samples"]} samples) and loop '
                          f'({gq["steps"]} steps)'),
            'quadrotor_3D': 'not on the GP-MPC path'}[system]
        row['safety_launches'] = sf_launches[PHYSICS[system]['name']]
        c5, cp, cbf = sf_rows['config5'], sf_rows['cartpole_mpsc'], sf_rows['cbf']
        row['safety_shape'] = {
            'cartpole': (f'B=1: linear MPSC learn() ({cp["learn"]["n_samples"]} steps) and an '
                         f'LQR loop certified by it ({cp["lqr loop"]["steps"]} steps), 50 '
                         f'substeps; CBF and CBF-NN LQR loops ({cbf["cbf"]["loop"]["steps"]} and '
                         f'{cbf["cbf_nn"]["loop"]["steps"]} steps), 1 substep'),
            'quadrotor': (f'B=1: config 5, SAC uncertified ({c5["uncertified"]["steps"]} steps) '
                          f'and certified by linear MPSC ({c5["certified"]["steps"]} steps, and '
                          'a 2-step profiler window), 20 substeps'),
            'quadrotor_3D': 'not on the safety path'}[system]
        row['off_policy_launches'] = op_launches[PHYSICS[system]['name']]
        sc, dd = op_rows['sac cartpole'], op_rows['ddpg cartpole']
        row['off_policy_shape'] = {
            'cartpole': (f'SAC collects B={sc["envs"]} ({sc["total_steps"]} env steps) and its '
                         f'10-episode eval, DDPG collects B={dd["envs"]} '
                         f'({dd["total_steps"]} env steps), 1 substep'),
            'quadrotor': (f'SAC collects B={op_rows["sac quadrotor_2D"]["envs"]} '
                          f'({op_rows["sac quadrotor_2D"]["total_steps"]} env steps), '
                          '20 substeps'),
            'quadrotor_3D': (f'SAC collects B={op_rows["sac quadrotor_3D"]["envs"]} '
                             f'({op_rows["sac quadrotor_3D"]["total_steps"]} env steps), '
                             '20 substeps')}[system]
        row['robust_launches'] = rb_launches.get(PHYSICS[system]['name'], 0)
        row['robust_shape'] = {
            'cartpole': (f'RARL and RAP collects B={rb_rows["rarl"]["envs"]} '
                         f'({rb_rows["rarl"]["total_steps"]} env steps each, the adversary\'s '
                         'tab force in the force operand, 50 substeps); SafeExplorerPPO: the '
                         f'committed model\'s episode B=1 '
                         f'({int(rb_rows["safe_explorer cartpole"]["average_length"])} steps), '
                         'pretraining and one PPO iteration '
                         f'B={rb_rows["safe_explorer train"]["envs"]} '
                         f'({rb_rows["safe_explorer train"]["pretrain_steps"]} + '
                         f'{rb_rows["safe_explorer train"]["T"]} steps), 1 substep'),
            'quadrotor': (f'one RARL rollout B={rb_rows["rarl quadrotor_2D"]["envs"]} '
                          f'T={rb_rows["rarl quadrotor_2D"]["T"]}, the adversary\'s world '
                          'force in the force operand; SafeExplorerPPO: the committed 2D '
                          f'model\'s episode B=1 '
                          f'({int(rb_rows["safe_explorer quadrotor_2D"]["average_length"])} '
                          'steps); 20 substeps'),
            'quadrotor_3D': 'not on the robust path'}[system]
        row['experiment_launches'] = ex_launches[PHYSICS[system]['name']]
        vec = ex_rows['vec_env'][system]
        row['experiment_shape'] = (
            f'make_vec_envs B={vec["envs"]} T={vec["T"]}'
            + (f'; train() B={ex_rows["train"]["envs"]} T={ex_rows["train"]["T"]} x '
               f'{ex_rows["train"]["iterations"]} iterations; HPO: 2 sequential trials '
               f'(B=16, 2 x T=100 and a 251-step eval each) and one vectorized round of '
               f'{ex_rows["vectorized"]["lanes"]} lanes as one population '
               f'(B={ex_rows["vectorized"]["envs"]}, 2 x T=100, then '
               f'{ex_rows["vectorized"]["lanes"] * HPO_N_EVAL} envs x 251 eval steps)'
               if system == 'cartpole' else ''))
        row['env_extras_launches'] = xt_launches[PHYSICS[system]['name']]
        row['env_extras_shape'] = (
            f'B={B_EXTRAS} T={T_EXTRAS_RAND[system]}, the shared-parameter case beside '
            'the randomized one' + (
                f'; the pyb replay T={T_EXTRAS_MODES[QUAD_TYPE[system]]}'
                if system != 'cartpole' else ''))
        row['multigpu_launches'] = mg_launches[PHYSICS[system]['name']]
        row['multigpu_shape'] = (
            f'the {MG_WORLD} gloo ranks sharing the card: PPO (dp, and dp x tp on a (1, '
            f'{MG_WORLD}) mesh) 64 x 150 x {MG_PPO_ITERATIONS} iteration, SAC and RARL, the '
            f'population, evaluate_fused B={MG_B} T={MG_EVAL_T}; each rank its rows'
            if system == 'cartpole' else 'not on the multigpu path')
        row['examples_launches'] = eg_launches[PHYSICS[system]['name']]
        row['examples_shape'] = {
            'cartpole': ('B=1: verbose_api, lqr/mpc/mpsc/cbf_experiment and rl_experiment on '
                         'the trained models, the scenario demo, the filter\'s learn(), the '
                         f'differentiable simulation (T={EX_DIFF[0]}); B={EX_B}: iLQR\'s two '
                         'solves; GP-MPC\'s learn(); HPO, train_rl and generate_pretrained '
                         'training'),
            'quadrotor': f'B=1: rl_experiment of the committed SAC model ({EX_STEPS} steps)',
            'quadrotor_3D': (f'B=1: pid_experiment on the custom waypoints ({EX_STEPS} steps, '
                             'set_reference)')}[system]
        row['chain_cycles_per_substep'] = serial['cycles'][system]
        row['sm_clock_ghz'] = serial['clock_ghz']
        row['chain_bound_ms'] = cycles_ms(serial['cycles'][system] * N_SUB)
        row['share_of_chain_bound'] = row['chain_bound_ms'] / row['ms']
        row['fast_path_per_substep'] = serial['fast_path'][system]['advance']
        row['issue_floor_ms'] = cycles_ms(row['fast_path_per_substep'] * N_SUB)
        row['share_of_issue_floor'] = row['issue_floor_ms'] / row['ms']
        row['floor_binds'] = 'issue' if row['issue_floor_ms'] > row['chain_bound_ms'] else 'chain'
        row = rollout[system]
        row['launches'] = launches[ROLLOUT[system]['name']]
        main_row = rows[f'rollout {system} constrained=True tracking=False']
        row['main_path_ms'] = main_row['kernel_ms']
        kw = {'constrained': True, 'randomized_reset': system == 'cartpole'}
        row['main_path_bound_ms'] = bound_ms(
            rollout_bytes(system, kw, T_ROLLOUT),
            rollout_ops(system, kw, T_ROLLOUT,
                        main_row['mean_done_count'] * B))[0]
        row['main_path_shape'] = f'B={B} T={T_ROLLOUT} constrained'
        # The chain bound: T x n_substeps x one substep's loop-carried chain
        # (the per-step kernel's loop) at the latencies and the SM clock
        # measured in this run.
        cycles = serial['cycles'][system]
        row['chain_cycles_per_substep'] = cycles
        row['chain_cycles_table_estimate'] = serial['table_cycles'][system]
        row['chain_latencies'] = serial['latency']
        row['chain_bound_by'] = 'latencies measured in this run (csrc/latency_probe.cu)'
        row['sm_clock_ghz'] = serial['clock_ghz']
        row['chain_bound_ms'] = cycles_ms(cycles * T_ROLLOUT * N_SUB)
        row['share_of_chain_bound'] = row['chain_bound_ms'] / row['main_path_ms']
        row['fast_path_per_substep'] = serial['fast_path'][system]['rollout']
        row['issue_floor_ms'] = cycles_ms(row['fast_path_per_substep'] * T_ROLLOUT * N_SUB)
        row['share_of_issue_floor'] = row['issue_floor_ms'] / row['main_path_ms']
        row['floor_binds'] = 'issue' if row['issue_floor_ms'] > row['chain_bound_ms'] else 'chain'
        row['lanes_per_env'] = 1
        times = serial['times']
        for case in ('random', 'hover', 'hover_tilted'):
            if (system, case) in times:
                row[f'{case}_ns_per_substep'] = times[system, case]['ns_per_substep']
        big = times[system, 'random_big_batch']
        row['big_batch_ms'] = big['ms']
        row['big_batch_shape'] = f'B={big["B"]} T={big["T"]} constrained (reported, not gated)'
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    ordered = [physics['cartpole'], physics['quadrotor'], physics['quadrotor_3D'],
               rollout['cartpole'], rollout['quadrotor'], rollout['quadrotor_3D'],
               policy['cartpole'], policy['quadrotor'], policy['quadrotor_3D']]
    kernels = [{**{k: row[k] for k in keys}, **{k: v for k, v in row.items() if k not in keys}}
               for row in ordered]
    # wall_seconds counts from before torch's import, as the command's clock does.
    emit('done', wall_seconds=time.perf_counter() - _T_START, seconds_by_phase=seconds,
         card=smi)
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    main()
