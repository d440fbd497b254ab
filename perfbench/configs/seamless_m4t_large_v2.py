"""Model FLOPs of one worker's training step of seamless_m4t_large_v2
(PaLM, appendix B): 6 x the parameters of every matrix product x the
positions it is applied to -- the encoder's over the frames; the decoder's
self attention, the cross attention's query and output, the MLP and the
head over the target tokens; the cross attention's key and value over the
frames -- plus 12 x layers x heads x head_dim x the attended length for
each position: the encoder over its frames, the decoder's self attention
over the row, its cross attention over the frames.  The input embedding,
the norms and remat's recompute are not counted."""


def model_flops(arch: dict, rows: int, seq: int, frames: int = 0) -> float:
    d, h, kh, dh, f = (arch[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    attn = d * h * dh * 2 + d * kh * dh * 2
    mlp = (3 if arch["mlp_activation"] in ("swiglu", "geglu") else 2) * d * f
    enc_l, dec_l = arch["n_encoder_layers"], arch["n_layers"]
    tokens, frame_pos = rows * seq, rows * frames
    enc = 6.0 * enc_l * (attn + mlp) * frame_pos + 12.0 * enc_l * h * dh * frames * frame_pos
    dec_per_token = dec_l * (attn + d * h * dh * 2 + mlp) + d * arch["vocab_size"]
    dec = 6.0 * dec_per_token * tokens + 6.0 * dec_l * (d * kh * dh * 2) * frame_pos
    dec += 12.0 * dec_l * h * dh * (seq + frames) * tokens
    return enc + dec
