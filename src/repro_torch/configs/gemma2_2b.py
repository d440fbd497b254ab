"""gemma2-2b [dense]: 26L, d_model=2304, 8H (GQA kv=4), d_ff=9216,
vocab=256000 -- local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]  (Same values as ``repro.configs.gemma2_2b``.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2_2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    mlp_activation="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    tie_embeddings=True,
)
