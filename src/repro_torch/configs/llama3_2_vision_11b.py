"""llama-3.2-vision-11b [vlm]: 40L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=128256 -- cross-attn image layers every 5th.  Vision frontend is a STUB
(precomputed patch embeddings).  [hf:meta-llama/Llama-3.2-11B-Vision]
(Same values as ``repro.configs.llama3_2_vision_11b``.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3_2_vision_11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    cross_attn_period=5,
    frontend="vision_patches",
    n_frontend_tokens=1601,
)
