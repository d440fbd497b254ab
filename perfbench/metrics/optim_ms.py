"""optim_ms (ms): device milliseconds a step of the optimizer
(src/repro_torch/optim: clipping and AdamW), from the steps traced with
stacks (each kernel to the layer of its launching op's innermost program
frame)."""


def read(record):
    value = (record.get("layer_ms") or {}).get("optimizer")
    return value if value else None
