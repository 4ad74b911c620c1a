"""Write the CNN's parameters as a ``.caffemodel`` and a mean image as a
``.binaryproto`` (``models/caffe_export.py`` of the JAX package), in numpy.

The counterpart of ``caffe_import``: a NetParameter whose layers carry the
blobs in Caffe's layout (conv OIHW, fc ``(out, in)``) in either the modern
``layer`` framing (field 100, LayerParameter) or the legacy ``layers``
framing (field 2, V1LayerParameter), with the surrounding fields (type,
bottom and top names) that a file written by Caffe has. A low-rank fc
layer (``u``, ``v``) is written as its dense product. Two uses: files of
the real network's size for the importer (the 2017 artifact is a download),
and handing trained weights to a Caffe deployment.

The bytes are the JAX exporter's for the same parameters. A message is
written piece by piece with its length computed first, so the 1 GB fc6
blob is never copied into a larger buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import weights as wload
from .caffe_import import CONV_NAMES, FC_NAMES


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _len_field(num: int, pieces: list) -> list:
    """A length-delimited field around ``pieces`` (bytes or memory views),
    as a list of pieces."""
    size = sum(len(p) for p in pieces)
    return [_field(num, 2, _varint(size)), *pieces]


def blob_pieces(arr: np.ndarray, legacy_shape: bool = False) -> list:
    """BlobProto: packed float data (5) and a BlobShape (7), or the legacy
    dims (1-4: num, channels, height, width) before the data."""
    data = memoryview(np.ascontiguousarray(arr, dtype="<f4")).cast("B")
    if legacy_shape:
        dims = ([1] * (4 - arr.ndim) + list(arr.shape))[:4]
        head = b"".join(_field(i + 1, 0, _varint(d))
                        for i, d in enumerate(dims))
        return [head, *_len_field(5, [data])]
    shape_msg = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
    return [*_len_field(5, [data]), *_len_field(7, [shape_msg])]


def _layer_blobs(name: str, layer: dict) -> list[np.ndarray]:
    """Caffe's [weight, bias] of one layer from the JAX-layout arrays."""
    w = layer["u"] @ layer["v"] if "u" in layer else layer["w"]
    # HWIO -> OIHW for a conv, (in, out) -> (out, in) for an fc layer
    w = np.transpose(w, (3, 2, 0, 1)) if name in CONV_NAMES else w.T
    return [w, layer["b"]]


def params_to_caffemodel(params: dict, path: str,
                         legacy: bool = False) -> None:
    """Write this port's parameters (``weights.load_params_and_mean``, a
    model's ``params()``) as a .caffemodel.

    ``legacy=True`` writes the V1LayerParameter framing (field 2, name = 4,
    blobs = 6, legacy blob dims) of Caffe snapshots from before 2014;
    otherwise the LayerParameter framing (field 100, name = 1, blobs = 7).
    """
    arrays = wload.params_to_numpy(params)
    with open(path, "wb") as fh:
        # NetParameter.name
        fh.write(b"".join(_len_field(1, [b"AlexNet_for_VP_classification"])))
        for name in CONV_NAMES + FC_NAMES:
            blobs = _layer_blobs(name, arrays[name])
            if legacy:
                msg = _len_field(4, [name.encode()])
                msg.append(_field(5, 0, _varint(4)))  # V1 type enum
                for arr in blobs:
                    msg += _len_field(6, blob_pieces(arr, legacy_shape=True))
                net_field = 2
            else:
                msg = _len_field(1, [name.encode()])
                msg += _len_field(2, [b"Convolution" if name in CONV_NAMES
                                      else b"InnerProduct"])
                msg += _len_field(3, [name.encode()])             # bottom
                msg += _len_field(4, [(name + "_out").encode()])  # top
                for arr in blobs:
                    msg += _len_field(7, blob_pieces(arr))
                net_field = 100
            for piece in _len_field(net_field, msg):
                fh.write(piece)


def mean_to_binaryproto(mean, path: str) -> None:
    """Write a (H, W) mean image (numpy or tensor) as Caffe's
    mean.binaryproto, one BlobProto with legacy dims."""
    if torch.is_tensor(mean):
        mean = mean.detach().cpu().numpy()
    arr = np.asarray(mean, np.float32)[None, None]
    with open(path, "wb") as fh:
        for piece in blob_pieces(arr, legacy_shape=True):
            fh.write(piece)
