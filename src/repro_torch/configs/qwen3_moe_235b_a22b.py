"""qwen3-moe-235b-a22b [moe]: 94L, d_model=4096, 64H (GQA kv=4), d_ff=1536
(per-expert), vocab=151936 -- 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]
(Same values as ``repro.configs.qwen3_moe_235b_a22b``.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_moe_235b_a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    rope_theta=1e6,
    n_experts=128,
    experts_per_token=8,
)
