"""hymba-1.5b [hybrid]: 32L, d_model=1600, 25H (GQA kv=5), d_ff=5504,
vocab=32001, ssm_state=16 -- parallel attention + mamba heads.
[arXiv:2411.13676; hf]
(Same values as ``repro.configs.hymba_1_5b``.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba_1_5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
)
