"""Optimizers of the port (``apex_tpu/optimizers``): optax-style
``GradientTransformation``s.  FusedAdam and FusedLAMB run as
multi-tensor kernels on the card and carry the AMP step's fused tail;
SGD, Adagrad, NovoGrad and LARS are torch compositions (NovoGrad's and
LARS's norms through ``multi_tensor_l2norm``)."""

from apex_tpu_torch.optimizers._common import (  # noqa: F401
    GradientTransformation,
    apply_updates,
    global_norm,
)
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    AdamState,
    FusedAdam,
    fused_adam,
)
from apex_tpu_torch.optimizers.fused_adagrad import (  # noqa: F401
    AdagradState,
    FusedAdagrad,
    fused_adagrad,
)
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    LambState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.fused_lars import (  # noqa: F401
    FusedLARS,
    LARSState,
    fused_lars,
)
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (  # noqa: F401
    FusedMixedPrecisionLamb,
    fused_mixed_precision_lamb,
)
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad,
    NovoGradState,
    fused_novograd,
)
from apex_tpu_torch.optimizers.fused_sgd import (  # noqa: F401
    FusedSGD,
    SGDState,
    fused_sgd,
)
