"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``physics_kernels``: K1, one cartpole control step (counterpart of
  ``safe_control_gym_tpu/ops/pallas_kernels.py``).
* ``rollout_kernels``: K4, the whole open-loop cartpole rollout in one launch
  (counterpart of ``safe_control_gym_tpu/ops/rollout_kernels.py``).

A wrapper runs the plain version for tensors on the CPU, launches its kernel
for tensors on a CUDA device, and raises for anything else.
"""
