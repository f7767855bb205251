"""mamba2-370m — Mamba-2 (SSD) evaluation size (Dao & Gu: 48 layers,
d_model=1024, d_state=64, head dim 64 → 32 heads at expand=2).

Same PackMamba packing rules as mamba-110m, with a scalar decay per head:
the scan is the head-structured ``selective_scan_heads``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="mamba",
    n_layers=48,
    d_model=1024,
    vocab=50280,
    d_state=64, d_conv=4, expand=2,
    ssm_variant="mamba2", ssm_head_dim=64,
))
