"""wire_mb_per_step (MB): the bytes each worker sends in a step's collectives
(the ring model's link bytes of every collective the step dispatched, from
the frozen copy of the port's collective recorder), in millions."""


def read(record):
    value = record.get("wire_bytes_per_step")
    return value / 1e6 if value else None
