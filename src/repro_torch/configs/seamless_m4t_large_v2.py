"""seamless-m4t-large-v2 [audio]: enc-dec, 24L, d_model=1024, 16H (kv=16),
d_ff=8192, vocab=256206.  [arXiv:2308.11596; hf]
Audio frontend is a STUB: input_specs provides precomputed frame embeddings.
RoPE replaces the original relative bias (DESIGN.md §7).
(Same values as ``repro.configs.seamless_m4t_large_v2``.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_large_v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_activation="relu",
    frontend="audio_frames",
)
