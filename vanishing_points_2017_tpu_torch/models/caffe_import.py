"""Import Caffe artifacts: ``.caffemodel`` weights and the ``.binaryproto``
mean blob (``models/caffe_import.py`` of the JAX package), in numpy.

The 2017 reference loads ``cnn/weights.caffemodel`` and
``cnn/mean.binaryproto`` through pycaffe. This module parses the protobuf
wire format itself, with no Caffe and no compiled schema, and takes only
what the network needs:

* NetParameter: ``layer`` (field 100, LayerParameter) and the legacy
  ``layers`` (field 2, V1LayerParameter), the modern one first.
* LayerParameter: ``name`` (1), ``blobs`` (7); V1LayerParameter: ``name``
  (4), ``blobs`` (6).
* BlobProto: ``data`` (5, packed float), ``double_data`` (8), ``shape``
  (7 -> BlobShape.dim (1)), the legacy ``num/channels/height/width`` (1-4).

:func:`caffemodel_to_params` returns numpy arrays in the JAX package's
layout (conv HWIO, fc ``(in, out)``), which ``weights.params_from_numpy``
turns into this port's like every other source. The fc6 input order is
Caffe's NCHW flatten, which ``models/cnn.py`` reproduces. Messages are
sliced as memory views, so a 1 GB file is held once.
"""

from __future__ import annotations

import numpy as np

CONV_NAMES = ("conv1", "conv2", "conv3", "conv4", "conv5")
FC_NAMES = ("fc6", "fc7", "fc8_20x20")


def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_fields(buf) -> dict[int, list]:
    """One message level: {field number: [raw values]}. Wire type 0 ->
    int, 2 -> a view of the bytes, 5 -> 4 bytes, 1 -> 8 bytes."""
    buf = memoryview(buf)
    fields: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _blob_to_array(blob) -> np.ndarray:
    f = parse_fields(blob)
    for field, dtype in ((5, "<f4"), (8, "<f8")):  # data, double_data
        if field in f:
            chunks = f[field]
            raw = chunks[0] if len(chunks) == 1 else b"".join(chunks)
            data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
            break
    else:
        raise ValueError("blob has no data field")
    if 7 in f:  # BlobShape
        shape = [int(d) for d in parse_fields(f[7][0]).get(1, [])]
    else:  # legacy num/channels/height/width
        shape = [int(f.get(i, [1])[0]) for i in (1, 2, 3, 4)]
    shape = [s for s in shape if s > 0] or [data.size]
    return data.reshape(shape)


def read_mean_binaryproto(path: str) -> np.ndarray:
    """mean.binaryproto -> (H, W) float32 mean image (channel squeezed)."""
    with open(path, "rb") as fh:
        arr = _blob_to_array(fh.read())
    return np.squeeze(arr).astype(np.float32)


def read_caffemodel(path: str) -> dict[str, list[np.ndarray]]:
    """caffemodel -> {layer name: [blob arrays]} for layers with weights."""
    with open(path, "rb") as fh:
        net = parse_fields(fh.read())
    out: dict[str, list[np.ndarray]] = {}
    # modern framing first (name = 1, blobs = 7), else the legacy V1
    # framing (name = 4, blobs = 6)
    for net_field, name_field, blob_field in ((100, 1, 7), (2, 4, 6)):
        for layer_bytes in net.get(net_field, []):
            lf = parse_fields(layer_bytes)
            if blob_field not in lf:
                continue
            name = (bytes(lf[name_field][0]).decode()
                    if name_field in lf else "?")
            out[name] = [_blob_to_array(b) for b in lf[blob_field]]
        if out:
            break
    return out


def caffemodel_to_params(path: str) -> dict:
    """caffemodel -> ``{layer: {"w", "b"}}`` float32 numpy in the JAX
    package's layout: conv OIHW -> HWIO (a grouped conv keeps I =
    in / groups), fc (out, in) -> (in, out)."""
    params = {}
    for name, arrs in read_caffemodel(path).items():
        if name in CONV_NAMES:
            w, b = arrs[0], arrs[1]
            w = np.transpose(w.reshape(w.shape[-4:]), (2, 3, 1, 0))
        elif name in FC_NAMES:
            w, b = arrs[0], arrs[1]
            w = w.reshape(w.shape[-2:]).T
        else:
            continue
        params[name] = {"w": w, "b": b.ravel()}
    missing = set(CONV_NAMES + FC_NAMES) - set(params)
    if missing:
        raise ValueError(f"caffemodel missing layers: {sorted(missing)}")
    return params
