"""Multi-tensor ops of the port (``apex_tpu/multi_tensor``): one kernel
launch over a whole tensor list (``csrc/multi_tensor.cu``)."""

from apex_tpu_torch.multi_tensor.multi_tensor_apply import (  # noqa: F401
    MultiTensorApply,
    amp_C,
    multi_tensor_adam,
    multi_tensor_applier,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_lamb,
    multi_tensor_scale,
)
