"""mamba-1.4b — paper §4: 48 layers, d_model=2048."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba-1.4b",
    family="mamba",
    n_layers=48,
    d_model=2048,
    vocab=50280,
    d_state=16, d_conv=4, expand=2,
))
