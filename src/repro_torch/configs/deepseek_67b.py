"""deepseek-67b [dense] — llama-arch. 95L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=102400 [arXiv:2401.02954; hf]. The largest dense config:
its 6.7e10 parameters are 134 GB in bf16, more than one 80 GB card holds,
so the port counts its cells on the meta device only. Full attention:
long_500k is skipped."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    act="swiglu",
))
