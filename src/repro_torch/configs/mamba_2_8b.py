"""mamba-2.8b — paper §4: 64 layers, d_model=2560."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba-2.8b",
    family="mamba",
    n_layers=64,
    d_model=2560,
    vocab=50280,
    d_state=16, d_conv=4, expand=2,
))
