"""model_ms (ms): device milliseconds a step of the model
(src/repro_torch/models: forward, backward and remat's recompute), from
the steps traced with stacks (each kernel to the layer of its launching
op's innermost program frame)."""


def read(record):
    value = (record.get("layer_ms") or {}).get("models")
    return value if value else None
