"""mixtral-8x22b [moe]: 56L, d_model=6144, 48H (GQA kv=8), d_ff=16384,
vocab=32768 -- 8 experts top-2, sliding-window attention (per assignment).
[arXiv:2401.04088; hf]
(Same values as ``repro.configs.mixtral_8x22b``.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral_8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
)
