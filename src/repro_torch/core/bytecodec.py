"""Versioned byte codec for compressed payloads (port of
``repro.core.bytecodec``): ``FFTPayload`` and ``StackedPayload`` as bytes a
separate process can read back, whichever package wrote them.

    blob    = to_bytes(payload)
    payload = from_bytes(blob, device)

Format (integers little-endian), byte for byte the reference's for the same
planes:

    [0:4]    magic  b"RPAY"
    [4:8]    u32    header length H
    [8:8+H]  JSON   header, keys sorted (utf-8)
    [8+H:]   the planes' bytes, in header order, C order, little-endian

The header holds the format version, the payload kind, its static fields
(``sizes`` or ``orig_len``, ``chunk``, ``has_im``) and one ``{name, dtype,
shape}`` per plane (``re``, ``im``, ``idx``, then the quantizer's four
leaves and its ``n_bits``/``m_bits`` when quantization is on), dtypes by
their numpy names.  ``from_bytes`` refuses a bad magic, another version, an
unknown kind or a truncated blob, and tolerates header keys it does not
know.
"""

from __future__ import annotations

import json
import struct
from typing import List, Tuple, Union

import numpy as np
import torch

from repro_torch.core.compressor import FFTPayload, StackedPayload
from repro_torch.core.quantizer import FittedQuantizer, RangeQuantConfig

__all__ = ["FORMAT_VERSION", "MAGIC", "to_bytes", "from_bytes"]

MAGIC = b"RPAY"
FORMAT_VERSION = 1

# the quantizer's leaves in serialization order (FittedQuantizer's fields)
_QUANT_LEAVES = ("eps", "p_codes", "vmax", "vmin")

# plane dtypes by their numpy names
_DTYPES = {torch.float32: "float32", torch.int32: "int32", torch.int16: "int16",
           torch.uint8: "uint8", torch.int8: "int8", torch.uint16: "uint16"}
_TORCH_DTYPES = {name: dtype for dtype, name in _DTYPES.items()}


def _host(t: torch.Tensor) -> Tuple[dict, bytes]:
    """(the plane's dtype and shape, its C-order little-endian bytes).  The
    bytes are the tensor's own memory: the hosts this runs on are
    little-endian.  A scalar is written with shape [1], as the reference
    writes it (its host copy is at least 1-d), so it reads back 1-d."""
    if t.dtype not in _DTYPES:
        raise TypeError(f"cannot serialize a {t.dtype} plane")
    flat = t.detach().reshape(-1).contiguous().cpu()
    return ({"dtype": _DTYPES[t.dtype], "shape": list(t.shape) or [1]},
            flat.view(torch.uint8).numpy().tobytes())


def to_bytes(payload: Union[FFTPayload, StackedPayload]) -> bytes:
    """A payload as one self-describing blob."""
    if isinstance(payload, StackedPayload):
        kind, aux = "stacked", {"sizes": [int(s) for s in payload.sizes]}
    elif isinstance(payload, FFTPayload):
        kind, aux = "fft", {"orig_len": int(payload.orig_len)}
    else:
        raise TypeError(f"cannot serialize {type(payload).__name__}")
    planes: List[Tuple[dict, bytes]] = []
    for name in ("re", "im", "idx"):
        desc, raw = _host(getattr(payload, name))
        planes.append(({"name": name, **desc}, raw))
    quant_hdr = None
    if payload.quant is not None:
        q = payload.quant
        quant_hdr = {"n_bits": q.config.n_bits, "m_bits": q.config.m_bits, "planes": []}
        for leaf in _QUANT_LEAVES:
            desc, raw = _host(getattr(q, leaf))
            quant_hdr["planes"].append({"name": leaf, **desc})
            planes.append(({"name": f"quant.{leaf}", **desc}, raw))
    header = {"magic": "RPAY", "format_version": FORMAT_VERSION, "kind": kind,
              "chunk": int(payload.chunk), "has_im": bool(payload.has_im),
              "planes": [desc for desc, _ in planes[:3]], "quant": quant_hdr, **aux}
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    return b"".join([MAGIC, struct.pack("<I", len(hdr)), hdr] + [raw for _, raw in planes])


def _read_plane(buf: memoryview, off: int, desc: dict, device) -> Tuple[torch.Tensor, int]:
    if desc["dtype"] not in _TORCH_DTYPES:
        raise ValueError(f"plane {desc['name']!r} has an unknown dtype {desc['dtype']!r}")
    dtype = _TORCH_DTYPES[desc["dtype"]]
    shape = tuple(int(d) for d in desc["shape"])
    nbytes = torch.empty((), dtype=dtype).element_size() * int(np.prod(shape, dtype=np.int64))
    if off + nbytes > len(buf):
        raise ValueError(f"payload blob truncated: plane {desc['name']!r} needs {nbytes} bytes "
                         f"at offset {off}, blob has {len(buf)}")
    raw = torch.frombuffer(bytearray(buf[off:off + nbytes]), dtype=torch.uint8) if nbytes \
        else torch.empty(0, dtype=torch.uint8)
    return raw.view(dtype).reshape(shape).to(device), off + nbytes


def from_bytes(blob: bytes, device) -> Union[FFTPayload, StackedPayload]:
    """The payload of a :func:`to_bytes` blob (either package's), its planes
    on ``device``.  Raises ``ValueError`` on anything that is not a
    well-formed version-1 blob."""
    if len(blob) < 8 or blob[:4] != MAGIC:
        raise ValueError("not a payload blob (bad magic)")
    (hdr_len,) = struct.unpack("<I", blob[4:8])
    if len(blob) < 8 + hdr_len:
        raise ValueError("payload blob truncated: incomplete header")
    try:
        header = json.loads(blob[8:8 + hdr_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"payload header is not valid JSON: {e}") from None
    version = header.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported payload format version {version!r} "
                         f"(this reader supports {FORMAT_VERSION})")
    kind = header.get("kind")
    if kind not in ("fft", "stacked"):
        raise ValueError(f"unknown payload kind {kind!r}")
    buf, off = memoryview(blob), 8 + hdr_len
    arrays = {}
    for desc in header["planes"]:
        arrays[desc["name"]], off = _read_plane(buf, off, desc, device)
    quant = None
    if header.get("quant") is not None:
        qh, leaves = header["quant"], {}
        for desc in qh["planes"]:
            leaves[desc["name"]], off = _read_plane(buf, off, desc, device)
        missing = set(_QUANT_LEAVES) - set(leaves)
        if missing:
            raise ValueError(f"quantizer block missing leaves {sorted(missing)}")
        quant = FittedQuantizer(RangeQuantConfig(int(qh["n_bits"]), int(qh["m_bits"])),
                                *(leaves[name] for name in _QUANT_LEAVES))
    planes = (arrays["re"], arrays["im"], arrays["idx"], quant)
    chunk, has_im = int(header["chunk"]), bool(header["has_im"])
    if kind == "stacked":
        return StackedPayload(*planes, tuple(int(s) for s in header["sizes"]), chunk,
                              has_im=has_im)
    return FFTPayload(*planes, int(header["orig_len"]), chunk, has_im=has_im)
