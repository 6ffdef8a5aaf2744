"""Safety filters of the port, registered at import time: linear MPSC, CBF
and CBF-NN (the JAX package's ``safety_filters/__init__.py``)."""

from safe_control_gym_tpu_torch.utils.registration import register

register(idx='linear_mpsc',
         entry_point='safe_control_gym_tpu_torch.safety_filters.mpsc.linear_mpsc:LINEAR_MPSC',
         config_entry_point='safe_control_gym_tpu_torch.safety_filters.mpsc:linear_mpsc.json')
register(idx='cbf',
         entry_point='safe_control_gym_tpu_torch.safety_filters.cbf.cbf:CBF',
         config_entry_point='safe_control_gym_tpu_torch.safety_filters.cbf:cbf.json')
register(idx='cbf_nn',
         entry_point='safe_control_gym_tpu_torch.safety_filters.cbf.cbf_nn:CBF_NN',
         config_entry_point='safe_control_gym_tpu_torch.safety_filters.cbf:cbf_nn.json')
