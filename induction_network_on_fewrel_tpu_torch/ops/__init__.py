from induction_network_on_fewrel_tpu_torch.ops.attn import masked_selfattn_tm  # noqa: F401
from induction_network_on_fewrel_tpu_torch.ops.core import (  # noqa: F401
    masked_max,
    masked_mean,
    masked_softmax,
    resolve_backend,
    squash,
)
from induction_network_on_fewrel_tpu_torch.ops.lstm import bilstm_encoder_tm  # noqa: F401
