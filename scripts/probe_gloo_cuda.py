"""Which collectives gloo takes on CUDA tensors (GPU, two ranks, one card).

Ranks that share one card cannot use NCCL, so the port's parallel code
runs them over gloo with CUDA tensors (``chip_smoke.py``'s parallel phase).
This spawns two ranks on ``cuda:0`` through ``parallel.launch.run_ranks``
and ``parallel.distributed.initialize(backend="gloo")``, tries each
collective on CUDA tensors of the types the port sends, checks the
result, and prints one line per collective (``ok``, ``wrong result`` or
the error) with the card and torch version. A collective listed as
refused would have to be staged through a host tensor in
``parallel/mesh.py``.

    python scripts/probe_gloo_cuda.py
"""

from __future__ import annotations

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _rank(init_method: str) -> dict:
    import torch
    import torch.distributed as dist

    from vanishing_points_2017_tpu_torch.parallel import distributed

    dev = distributed.initialize(init_method, backend="gloo")
    rank = dist.get_rank()
    res = {}

    def attempt(name, fn, check):
        try:
            out = fn()
            torch.cuda.synchronize()
            res[name] = "ok" if check(out) else "wrong result"
        except RuntimeError as e:
            res[name] = f"refused: {str(e).splitlines()[0][:120]}"

    def full(dtype):
        return torch.full((4,), rank + 1, dtype=dtype, device=dev)

    total = sum(range(1, WORLD + 1))
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        def reduce(d=dtype):
            t = full(d)
            dist.all_reduce(t)
            return t
        attempt(f"all_reduce {dtype}", reduce,
                lambda t: bool((t.float() == total).all()))
    for dtype in (torch.float32, torch.bool, torch.uint8):
        def gather(d=dtype):
            parts = [torch.empty(4, dtype=d, device=dev)
                     for _ in range(WORLD)]
            dist.all_gather(parts, full(d) if d != torch.bool
                            else torch.ones(4, dtype=d, device=dev))
            return parts
        attempt(f"all_gather {dtype}", gather, lambda p: len(p) == WORLD)

    def gather_into():
        out = torch.empty(4 * WORLD, device=dev)
        dist.all_gather_into_tensor(out, full(torch.float32))
        return out
    attempt("all_gather_into_tensor", gather_into,
            lambda o: o.tolist() == [r + 1.0 for r in range(WORLD)
                                     for _ in range(4)])

    def broadcast():
        t = full(torch.float32)
        dist.broadcast(t, 0)
        return t
    attempt("broadcast", broadcast, lambda t: bool((t == 1).all()))

    def reduce_scatter():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter(out, [full(torch.float32) for _ in range(WORLD)])
        return out
    attempt("reduce_scatter", reduce_scatter,
            lambda t: bool((t == total).all()))

    def subgroup():
        g = dist.new_group(list(range(WORLD)))
        t = full(torch.float32)
        dist.all_reduce(t, group=g)
        return t
    attempt("all_reduce on a new_group", subgroup,
            lambda t: bool((t == total).all()))
    return res


def main() -> int:
    sys.path.insert(0, ROOT)
    import subprocess

    import torch

    from vanishing_points_2017_tpu_torch.parallel.launch import run_ranks

    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(_rank, WORLD, work_dir=tmp, timeout=120)
    for name, outcome in res[0].items():
        print(f"gloo, CUDA tensors, {WORLD} ranks on one card: {name}: "
              f"{outcome}")
    return 0 if all(v == "ok" for r in res for v in r.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
