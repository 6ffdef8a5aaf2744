"""safe-control-gym-tpu-torch: the PyTorch and CUDA port of ``safe_control_gym_tpu``.

The JAX package beside this one is the reference. This package imports
``torch`` and ``numpy`` only, never ``jax`` and nothing of
``safe_control_gym_tpu``. Its hot-path kernels are CUDA C++ for Hopper
(``csrc/``), each with a plain PyTorch version in the same module.

Every entry point takes ``device=`` and defaults to ``'cuda'``; without a
CUDA device it raises unless the caller passes ``device='cpu'``.

    from safe_control_gym_tpu_torch.utils.registration import make
    env = make('cartpole', device='cuda')
"""

__version__ = '0.1.0'

# Importing the envs, controllers and safety_filters subpackages populates
# the registry (as the JAX package does).
import safe_control_gym_tpu_torch.controllers  # noqa: F401,E402
import safe_control_gym_tpu_torch.envs  # noqa: F401,E402
import safe_control_gym_tpu_torch.safety_filters  # noqa: F401,E402
