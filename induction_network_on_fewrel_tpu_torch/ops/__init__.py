from induction_network_on_fewrel_tpu_torch.ops.attn import masked_selfattn_tm  # noqa: F401
from induction_network_on_fewrel_tpu_torch.ops.core import (  # noqa: F401
    masked_max,
    masked_mean,
    masked_softmax,
    resolve_backend,
    squash,
)
from induction_network_on_fewrel_tpu_torch.ops.lstm import (  # noqa: F401
    bilstm_encoder_tm,
    bilstm_recurrence_tm,
    lstm_recurrence,
    lstm_recurrence_grouped,
    lstm_scan,
)
