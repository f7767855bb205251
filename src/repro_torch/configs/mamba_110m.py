"""mamba-110m — the paper's smallest evaluation model (§4: 16 layers,
d_model=1024)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba-110m",
    family="mamba",
    n_layers=16,
    d_model=1024,
    vocab=50280,
    d_state=16, d_conv=4, expand=2,
))
