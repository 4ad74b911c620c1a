"""Low-rank factorization of the wide fully-connected layers
(``models/factorize.py`` of the JAX package), numpy only.

fc6 (57600 x 4096) is 94% of the dense network's ~950 MB. A truncated SVD
``w ~= u @ v`` of fc6 and fc7, then a short fine-tune, keeps the synthetic
AUC at a few tens of MB of float16 (the shipped
``assets/weights_compact.npz``). The parameters here are in the JAX
package's layout (``(in, out)`` fc matrices); ``VPNet`` applies a
factorized layer as ``x @ u @ v``. The same seed gives the same ``u`` and
``v`` as the JAX package.
"""

from __future__ import annotations

import numpy as np


def _randomized_svd(w: np.ndarray, rank: int, oversample: int = 16,
                    iters: int = 4, seed: int = 0):
    """Halko-style randomized truncated SVD (row x col, rank << min dim)."""
    rng = np.random.default_rng(seed)
    k = min(rank + oversample, min(w.shape))
    q = rng.standard_normal((w.shape[1], k)).astype(w.dtype)
    y = w @ q
    for _ in range(iters):  # power iterations sharpen the spectrum
        y, _ = np.linalg.qr(y)
        y = w @ (w.T @ y)
    q, _ = np.linalg.qr(y)
    b = q.T @ w
    ub, s, vt = np.linalg.svd(b, full_matrices=False)
    u = q @ ub[:, :rank]
    return u, s[:rank], vt[:rank]


def factorize_layer(w: np.ndarray, rank: int, seed: int = 0):
    """Dense (in, out) weight -> (u (in, r), v (r, out)) with w ~= u @ v;
    sqrt(s) goes on each factor so both have comparable scale for SGD."""
    u, s, vt = _randomized_svd(np.asarray(w, np.float32), rank, seed=seed)
    rs = np.sqrt(s)
    return (u * rs[None, :]).astype(np.float32), \
        (rs[:, None] * vt).astype(np.float32)


def factorize_params(params: dict, ranks: dict[str, int], seed: int = 0):
    """Factorize the named dense fc layers of a numpy parameter dict;
    other layers pass through unchanged."""
    out = {}
    for name, layer in params.items():
        if name in ranks and "w" in layer:
            u, v = factorize_layer(np.asarray(layer["w"]), ranks[name],
                                   seed=seed)
            out[name] = {"u": u, "v": v, "b": np.asarray(layer["b"])}
        else:
            out[name] = {k: np.asarray(a) for k, a in layer.items()}
    return out


def densify(params: dict):
    """Expand factorized layers back to dense ``{"w", "b"}`` (numpy)."""
    out = {}
    for name, layer in params.items():
        if "u" in layer:
            out[name] = {"w": np.asarray(layer["u"]) @ np.asarray(layer["v"]),
                         "b": np.asarray(layer["b"])}
        else:
            out[name] = {k: np.asarray(a) for k, a in layer.items()}
    return out
