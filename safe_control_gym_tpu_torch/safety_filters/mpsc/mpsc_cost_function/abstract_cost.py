"""The MPSC cost function's template.

Port of ``safe_control_gym_tpu/safety_filters/mpsc/mpsc_cost_function/abstract_cost.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

__all__ = ['MPSC_COST']


class MPSC_COST(ABC):
    """Abstract MPSC cost function class."""

    def __init__(self, env=None):
        self.env = env

    @abstractmethod
    def get_cost(self, opti_dict):
        """The cost's quadratic data in the first step's decision variables,
        which ``linear_mpsc`` assembles into its QP."""
        raise NotImplementedError

    def prepare_cost_variables(self, opti_dict, obs, iteration):
        """Hook to update cost parameters before solving."""
        return
