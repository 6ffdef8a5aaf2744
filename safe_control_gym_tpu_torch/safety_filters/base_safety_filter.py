"""The template of a safety filter.

Port of ``safe_control_gym_tpu/safety_filters/base_safety_filter.py``: a
controller whose ``select_action`` gives way to
``certify_action(state, action, info) -> (certified_action, success)``.
"""

from __future__ import annotations

from abc import abstractmethod

from safe_control_gym_tpu_torch.controllers.base_controller import BaseController

__all__ = ['BaseSafetyFilter']


class BaseSafetyFilter(BaseController):
    """Template for safety filters."""

    @abstractmethod
    def certify_action(self, current_state, uncertified_action, info=None):
        raise NotImplementedError

    def select_action(self, obs, info=None):
        raise NotImplementedError(
            '[ERROR] select_action is not and will not be implemented for safety filters.')
