"""exchange_ms (ms): device milliseconds a step of the exchange
(src/repro_torch/comms, core and kernels), from the steps traced with
stacks (each kernel to the layer of its launching op's innermost program
frame)."""


def read(record):
    value = (record.get("layer_ms") or {}).get("exchange")
    return value if value else None
