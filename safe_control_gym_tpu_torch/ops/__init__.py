"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``physics_kernels``: K1, K2 and K3, one cartpole, 2D-quad or 3D-quad
  control step (counterpart of ``safe_control_gym_tpu/ops/pallas_kernels.py``).
* ``rollout_kernels``: K4 and K5, the whole cartpole or quad rollout in one
  launch, open loop or with the actor MLP inside (policy mode; counterpart of
  ``safe_control_gym_tpu/ops/rollout_kernels.py``).

A wrapper runs the plain version for tensors on the CPU, launches its kernel
for tensors on a CUDA device, and raises for anything else.

``qp`` is the batched ADMM QP of the MPC family: library calls on the
inputs' device, as the JAX package's ``ops/qp.py`` is XLA, not Pallas.
"""
