"""Stand-ins shaped like the reference's stage-A networks (model.py:1200-1397),
for tests/test_torch_import_reference.py: the attributes both importers
read (``transformer_encoder.layers``, ``fc1``, ``fc2``, a discriminator's
``fc3``, the visual discriminator's ``object``), a positional table buffer
that they must not read, and a forward the test does not call.  The test
copies this file to ``model.py`` in a stand-in reference tree, so that the
pickles name the class path ``model.<Class>``, as the reference's do."""

import torch
from torch import nn


class _Encoder(nn.Module):
    def __init__(self, d_model, nhead, num_layers, dropout):
        super().__init__()
        layer = nn.TransformerEncoderLayer(d_model, nhead, 2048, dropout)
        self.transformer_encoder = nn.TransformerEncoder(layer, num_layers,
                                                         enable_nested_tensor=False)
        self.register_buffer("pe", torch.randn(110, 1, d_model))


class _Generator(_Encoder):
    D_MODEL, NHEAD, D_HIDDEN = 100, 10, 512

    def __init__(self, D_h, dropout, num_layers=2):
        super().__init__(self.D_MODEL, self.NHEAD, num_layers, dropout)
        self.fc1 = nn.Linear(self.D_MODEL, self.D_HIDDEN)
        self.fc2 = nn.Linear(self.D_HIDDEN, D_h)


class AcousticGenerator(_Generator):
    pass


class VisualGenerator(_Generator):
    D_MODEL, NHEAD, D_HIDDEN = 512, 8, 1024


class TextGenerator(_Generator):
    pass


class _Discriminator(_Encoder):
    def __init__(self, D_h, dropout, num_layers=2):
        super().__init__(D_h, 10, num_layers, dropout)
        self.fc1 = nn.Linear(D_h, 64)
        self.fc2 = nn.Linear(64, 16)
        self.fc3 = nn.Linear(16, 1)


class AcousticDiscriminator(_Discriminator):
    pass


class VisualDiscriminator(_Discriminator):
    def __init__(self, D_h, dropout, num_layers=2):
        super().__init__(D_h, dropout, num_layers)
        self.object = nn.Linear(512, D_h)


class TextDiscriminator(_Discriminator):
    pass
