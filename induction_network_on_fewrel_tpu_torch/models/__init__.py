from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel  # noqa: F401
from induction_network_on_fewrel_tpu_torch.models.build import (  # noqa: F401
    build_model,
    resolve_device,
    resolve_runtime_backends,
)
from induction_network_on_fewrel_tpu_torch.models.embedding import Embedding  # noqa: F401
from induction_network_on_fewrel_tpu_torch.models.encoders import (  # noqa: F401
    BiLSTMSelfAttnEncoder,
)
from induction_network_on_fewrel_tpu_torch.models.induction import (  # noqa: F401
    Induction,
    InductionNetwork,
    RelationNTN,
)
