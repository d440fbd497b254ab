"""qwen1.5-110b [dense]: 80L, d_model=8192, 64H (GQA kv=8), d_ff=49152,
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]
(Same values as ``repro.configs.qwen1_5_110b``.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1_5_110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)
