"""The network's weights and mean as the benchmark hands them to both
sides, the program and the reference.

The configuration's weights file is read as it is (``.npz``, keys
``layer/key``, convs HWIO, any float storage; the file's blake2b digest
must be the configuration's ``weights_fingerprint``). Its factorized
fc6/fc7 (``u`` (in, r), ``v`` (r, out)) are multiplied out on the device
in float32 with TF32 off into the dense ``w`` (in, out) of the published
network, so both sides run fc6 and fc7 at the configuration's widths.
The result is ``{layer: {"w", "b"}}`` of float32 tensors, convs OIHW
(``F.conv2d``'s layout, the port's too).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch


def fingerprint(path: str) -> str:
    """The file's blake2b digest, 8 bytes, in hex."""
    h = hashlib.blake2b(digest_size=8)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def load(config: dict, root: str, device) -> tuple[dict, torch.Tensor]:
    """-> (params, mean) on ``device``, as set out above. Raises where the
    file is not the configuration's or a layer's width is not the one the
    configuration's ``network`` states."""
    path = os.path.join(root, config["weights"])
    if fingerprint(path) != config["weights_fingerprint"]:
        raise RuntimeError(f"{path}: not the configuration's weights")
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if "/" not in key:
                continue
            layer, k = key.split("/")
            a = z[key].astype(np.float32)
            if k == "w" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            params.setdefault(layer, {})[k] = torch.tensor(
                np.ascontiguousarray(a), device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for p in params.values():
            if "u" in p:
                p["w"] = p.pop("u") @ p.pop("v")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for name, width in config["network"]["fc"]:
        if params[name]["w"].shape[1] != width:
            raise ValueError(f"{name}: width {params[name]['w'].shape[1]}, "
                             f"the configuration states {width}")
    mean = torch.tensor(
        np.load(os.path.join(root, config["mean"])).astype(np.float32),
        device=device)
    return params, mean
