from induction_network_on_fewrel_tpu_torch.data.bert_tokenizer import BertTokenizer  # noqa: F401
from induction_network_on_fewrel_tpu_torch.data.fewrel import (  # noqa: F401
    FewRelDataset,
    Instance,
    load_fewrel_json,
)
from induction_network_on_fewrel_tpu_torch.data.glove import GloveVocab, load_glove  # noqa: F401
from induction_network_on_fewrel_tpu_torch.data.tokenizer import (  # noqa: F401
    GloveTokenizer,
    TokenizedInstance,
)
from induction_network_on_fewrel_tpu_torch.data.synthetic import (  # noqa: F401
    make_domain_shifted_fewrel,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
