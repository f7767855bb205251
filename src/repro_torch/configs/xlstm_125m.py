"""xlstm-125m [ssm] — sLSTM + mLSTM blocks. 12L d_model=768 4H d_ff=0
vocab=50304 [arXiv:2405.04517; unverified].

xLSTM[7:1]-style mix expressed as a 6-layer pattern unit (5 mLSTM + 1 sLSTM,
repeated twice ⇒ sLSTM at depths 5 and 11). d_ff=0: mLSTM blocks carry their
own ×2 up-projection, no separate FFN. O(1) decode state."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    proj_factor=2.0,
    conv_width=4,
))
