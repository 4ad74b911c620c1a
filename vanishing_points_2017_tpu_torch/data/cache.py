"""Per-stage result cache with skip-if-present semantics
(``data/cache.py`` of the JAX package).

Each image gets one ``.npz`` per stage under a directory named by the
configuration key, so a changed configuration never reads another's
results and a crashed run resumes where it stopped.
"""

from __future__ import annotations

import os

import numpy as np


class StageCache:
    def __init__(self, root: str, config_key: str):
        self.dir = os.path.join(root, config_key)
        os.makedirs(self.dir, exist_ok=True)

    def path(self, image_name: str, stage: str) -> str:
        base = os.path.splitext(os.path.basename(image_name))[0]
        return os.path.join(self.dir, f"{base}.{stage}.npz")

    def has(self, image_name: str, stage: str) -> bool:
        return os.path.isfile(self.path(image_name, stage))

    def load(self, image_name: str, stage: str) -> dict:
        with np.load(self.path(image_name, stage), allow_pickle=False) as z:
            return dict(z)

    def save(self, image_name: str, stage: str, **arrays) -> None:
        tmp = self.path(image_name, stage) + ".tmp.npz"  # savez appends .npz
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, self.path(image_name, stage))
