"""gemma-7b [dense] — GeGLU, head_dim=256. 28L d_model=3072 16H (kv=16)
d_ff=24576 vocab=256000 [arXiv:2403.08295; hf]. Tied embeddings and the
√d_model embedding scale (the Gemma convention). Full attention: long_500k
is skipped."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    tie_embeddings=True,
))
