"""CNN parameter and mean-image loading (numpy only).

Counterpart of ``vanishing_points_2017_tpu/weights.py``: the shipped
artifact is ``assets/weights_compact.npz`` (float16 storage, conv weights
in HWIO, fc6/fc7 factorized as rank-256 ``u``/``v`` pairs) plus
``assets/mean.npy``; Caffe's ``.caffemodel`` and ``.binaryproto`` load
through ``models/caffe_import.py``. :func:`params_from_numpy` turns the JAX package's
parameter layout into this port's (OIHW conv weights, ``(in, out)`` fc
matrices kept as they are), so either package's checkpoints load here;
:func:`params_to_npz` writes this port's parameters back in the JAX
package's layout and file format, so its checkpoints load there too.
"""

from __future__ import annotations

import functools
import hashlib
import os
import sys

import numpy as np
import torch

from .device import require_device


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# dense-vs-compact notices already printed in this process
_notified: set = set()


def _notice(msg: str) -> None:
    """Which artifact wins changes every AUC and timing, so the choice is
    printed to stderr once per process, whatever the caller's verbosity."""
    if msg not in _notified:
        _notified.add(msg)
        print(msg, file=sys.stderr)


def default_weights_path() -> str:
    """The versioned factorized artifact ``assets/weights_compact.npz``,
    unless a dense retrain ``assets/weights.npz`` exists and is newer: then
    the retrain wins, with a notice (the JAX package's resolution, so both
    packages load the same weights from one checkout)."""
    assets = os.path.join(_repo_root(), "assets")
    dense = os.path.join(assets, "weights.npz")
    compact = os.path.join(assets, "weights_compact.npz")
    if os.path.isfile(dense):
        if not os.path.isfile(compact):
            return dense
        if os.path.getmtime(dense) >= os.path.getmtime(compact):
            _notice(f"weights: using dense retrain {dense} "
                    f"[{artifact_fingerprint(dense)}] (newer than the "
                    "versioned compact artifact)")
            return dense
        _notice(f"weights: IGNORING stale dense {dense} (older than the "
                "versioned compact artifact; delete it or retrain to "
                "use it)")
    return compact


def default_mean_path() -> str:
    return os.path.join(_repo_root(), "assets", "mean.npy")


def weights_identity(weights_path: str | None = None) -> str:
    """Fingerprint of the weights :func:`load_params_and_mean` loads for
    ``weights_path`` (default resolution included)."""
    return artifact_fingerprint(weights_path or default_weights_path())


def mean_identity(mean_path: str | None = None) -> str:
    """Fingerprint of the mean image :func:`load_params_and_mean` loads;
    it shifts the CNN's output as the weights do, so result caches key on
    it too."""
    return artifact_fingerprint(mean_path or default_mean_path())


@functools.lru_cache(maxsize=32)
def _fingerprint_cached(path: str, size: int, mtime_ns: int) -> str:
    h = hashlib.blake2b(digest_size=8)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def artifact_fingerprint(path: str | None) -> str:
    """Short content hash of a weights/mean artifact file — the same
    digest the JAX package reports (blake2b, 8 bytes), so records from
    both packages name an artifact alike. "none" for a missing file."""
    if not path or not os.path.isfile(path):
        return "none"
    st = os.stat(path)
    return _fingerprint_cached(os.path.abspath(path), st.st_size,
                               st.st_mtime_ns)


def params_npz_numpy(path: str) -> dict:
    """npz checkpoint -> nested ``{layer: {key: float32 ndarray}}`` in the
    JAX package's layout (storage may be float16)."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if key == "__step__":
                continue
            layer, k = key.split("/")
            v = z[key]
            if v.dtype.kind == "f":
                v = v.astype(np.float32)
            params.setdefault(layer, {})[k] = v
    return params


def params_to_numpy(params: dict) -> dict:
    """This port's parameters -> the JAX package's layout as float32 numpy
    (the inverse of :func:`params_from_numpy`): conv ``w`` OIHW -> HWIO,
    fc ``w``/``u``/``v`` and biases as they are."""
    out: dict = {}
    for layer, d in params.items():
        out[layer] = {}
        for k, v in d.items():
            a = v.detach().to("cpu", torch.float32).numpy()
            if k == "w" and a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            out[layer][k] = np.ascontiguousarray(a)
    return out


def params_to_npz(params: dict, path: str, step: int | None = None,
                  dtype=None) -> None:
    """Write a checkpoint the JAX package's ``params_from_npz`` reads:
    keys ``layer/key`` in its layout, plus ``__step__`` when ``step`` is
    given. ``dtype=np.float16`` halves the file (loading upcasts). Stored
    uncompressed: trained weights do not compress, and zlib on one core
    would stall training for minutes per snapshot."""
    flat = {}
    for layer, d in params_to_numpy(params).items():
        for k, v in d.items():
            flat[f"{layer}/{k}"] = v if dtype is None else v.astype(dtype)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)


def params_from_npz(path: str, with_step: bool = False,
                    device: str | torch.device = "cuda"):
    """Checkpoint of either package -> this port's parameters on
    ``device`` (the GPU unless the caller names another), and with
    ``with_step`` the step it was written at (0 when it has none)."""
    device = require_device(device)
    params = params_from_numpy(params_npz_numpy(path), device)
    if not with_step:
        return params
    with np.load(path) as z:
        return params, int(z["__step__"]) if "__step__" in z.files else 0


def params_from_numpy(params, device: str | torch.device = "cpu") -> dict:
    """JAX-layout parameters (nested dict, or flat ``"layer/key"`` dict) ->
    this port's layout as float32 tensors on ``device``.

    Conv ``w`` goes HWIO -> OIHW (``F.conv2d``'s layout, grouped convs
    included: I is already in_channels / groups). Fully-connected ``w``,
    ``u`` and ``v`` stay ``(in, out)`` matrices — the forward pass computes
    ``x @ w`` (``x @ u @ v`` for a factorized layer) exactly as the JAX
    forward does. Biases are unchanged.
    """
    nested: dict = {}
    for key, val in params.items():
        if isinstance(val, dict):
            nested.setdefault(key, {}).update(val)
        else:
            layer, k = key.split("/")
            nested.setdefault(layer, {})[k] = val
    out: dict = {}
    for layer, d in nested.items():
        out[layer] = {}
        for k, v in d.items():
            a = np.asarray(v, np.float32)
            if k == "w" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[layer][k] = torch.tensor(a, device=device)
    return out


def load_params_and_mean(weights_path: str | None = None,
                         mean_path: str | None = None,
                         device: str | torch.device = "cuda"):
    """-> (params, mean) as tensors on ``device`` (the GPU unless the
    caller names another); the shipped artifacts by default. The weights
    are an ``.npz`` checkpoint of either package or a ``.caffemodel``, the
    mean a ``.npy`` or a ``.binaryproto``. Raises when a named file does
    not exist, then when ``device`` is a GPU and none is present."""
    from .models import caffe_import

    weights_path = weights_path or default_weights_path()
    mean_path = mean_path or default_mean_path()
    for path in (weights_path, mean_path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{path}: no such file")
    device = require_device(device)
    if weights_path.endswith(".caffemodel"):
        arrays = caffe_import.caffemodel_to_params(weights_path)
    else:
        arrays = params_npz_numpy(weights_path)
    if mean_path.endswith(".binaryproto"):
        mean = caffe_import.read_mean_binaryproto(mean_path)
    else:
        mean = np.load(mean_path).astype(np.float32)
    return params_from_numpy(arrays, device), torch.from_numpy(mean).to(device)
