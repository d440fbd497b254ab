"""Model FLOPs of one worker's training step of phi3_medium_14b.l3 (PaLM,
appendix B): 6 x the parameters of every matrix product x the tokens, plus
12 x layers x heads x head_dim x the attended length for each token.  The
input embedding, the norms and remat's recompute are not counted; the
attended length is the whole row, as the step computes it."""


def model_flops(arch: dict, rows: int, seq: int, frames: int = 0) -> float:
    d, h, kh, dh, f = (arch[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    layer = d * h * dh * 2 + d * kh * dh * 2 + 3 * d * f  # q, o; k, v; gate, up, down
    matrices = arch["n_layers"] * layer + d * arch["vocab_size"]  # and the head
    tokens = rows * seq
    return 6.0 * matrices * tokens + 12.0 * arch["n_layers"] * h * dh * seq * tokens
