"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 attn:recurrent.

26L d_model=2560 10H (GQA kv=1 ⇒ MQA) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf]. Pattern unit (rec, rec, attn); 26 = 8×3 + 2, the two
remainder layers are recurrent. Local attention window 2048, head_dim 256
(Griffin convention). Every layer is its block, then a GeGLU MLP; the
embedding is tied to the head.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    act="geglu",
    attn_window=2048,
    pattern=("rec", "rec", "attn"),
    lru_width=2560,
    conv_width=4,
    tie_embeddings=True,
))
