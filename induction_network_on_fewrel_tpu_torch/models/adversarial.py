"""Domain discriminator for FewRel 2.0 adversarial domain adaptation.

Counterpart of ``induction_network_on_fewrel_tpu/models/adversarial.py``
(``DomainDiscriminator``): sentence encodings [M, H] -> domain logits
[M, 2] (0 = source, 1 = target) through fc1, fc2 (``hidden`` wide, leaky
ReLU of slope 0.01 after each) and out. It computes in f32 (the input is
cast inside the module) with flax's Dense inits, drawn from its own
``torch.Generator``. It is a training-time adversary: the adversarial step
(``train/steps.make_adv_train_step``) trains it against the encoder through
``ops.core.gradient_reversal``, and no checkpoint holds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.layers import Dense


class DomainDiscriminator(nn.Module):
    def __init__(self, feat_dim: int, hidden: int = 256, *, device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = Dense(feat_dim, hidden, torch.float32, **kw)
        self.fc2 = Dense(hidden, hidden, torch.float32, **kw)
        self.out = Dense(hidden, 2, torch.float32, **kw)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.fc1(feat.float()), 0.01)
        x = F.leaky_relu(self.fc2(x), 0.01)
        return self.out(x).float()
