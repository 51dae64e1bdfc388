"""apex_tpu_torch.comm (``apex_tpu/comm``): the codec half of its wire
quantization, :mod:`~apex_tpu_torch.comm.quantize`, which the KV handoff
codec (``serving/cluster/handoff.py``) uses.  The gradient collectives
are not ported yet."""
