"""Kernel K3 (``csrc/cluster_two.cu``), the EM split's average-linkage
2-clustering, against its plain twin ``em/cluster.agglomerative_two_ref``.

On the CPU: the wrapper's dispatch and input checks, and K3's place among
the port's kernels. Marked ``gpu``: K3 bit for bit against the twin on the
card (random, tie-heavy, NaN and huge distances, every active count from 0
to N = 512 around the shared-memory limit, the split inputs of a batch of
the benchmark cell ``sd640_scenes_b32``), and the EM's whole result on
that batch with K3 and with the twin. Run them on the GPU machine with

    python -m pytest --noconftest -m gpu tests/test_torch_cluster_kernel.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from vanishing_points_2017_tpu_torch import kernels
from vanishing_points_2017_tpu_torch.em import cluster
from vanishing_points_2017_tpu_torch.em import consensus
from vanishing_points_2017_tpu_torch.em import em as tem
from vanishing_points_2017_tpu_torch.utils import profiling
from torch_cpu import torch_threads  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import cell_batch, em_op_by_op, recording  # noqa: E402

SAME = dict(rtol=0, atol=0, equal_nan=True)


def distances(b, n, counts, seed=0, kind="random"):
    """(dist (B, N, N) float32, active (B, N) bool): image i has
    ``counts[i]`` active items at random places; ``kind`` "random"
    (symmetric, in [0, 2)), "ties" (symmetric, on a grid of 0.25),
    "nan" (symmetric, ~1% NaN), "asymmetric", or "huge" (half the entries
    at or above BIG, a tenth +inf, so the argmin reaches the inactive
    items)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 2, (b, n, n)).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 4) / 4
    if kind == "huge":
        x[rng.uniform(size=x.shape) < 0.5] = np.float32(2e12)
        x[rng.uniform(size=x.shape) < 0.1] = np.inf
        x[rng.uniform(size=x.shape) < 0.1] = np.float32(cluster.BIG)
    if kind != "asymmetric" and kind != "huge":
        x = np.triu(x, 1)
        x = x + np.transpose(x, (0, 2, 1))
    if kind == "nan":
        x[rng.uniform(size=x.shape) < 0.01] = np.nan
    active = np.zeros((b, n), bool)
    for i, c in enumerate(counts):
        active[i, rng.permutation(n)[:c]] = True
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(active)


# ---- the CPU


def test_wrapper_runs_the_twin_on_the_cpu(monkeypatch):
    dist, active = distances(3, 24, [0, 7, 24], kind="ties")
    counted = []
    monkeypatch.setattr(profiling, "count",
                        lambda name, n=1: counted.append(name))
    before = cluster.CLUSTER_KERNEL.launches
    got = cluster.agglomerative_two(dist, active)
    assert torch.equal(got, cluster.agglomerative_two_ref(dist, active))
    assert cluster.CLUSTER_KERNEL.launches == before
    # the twin's reads are counted, K3's launch is not
    assert "em.host_reads" in counted and "em.cluster_launches" not in counted
    assert not got[0].any() and int(got[1].sum()) >= 1


@pytest.mark.parametrize("what", ["float64", "int8 mask", "float mask",
                                  "non-square", "mask too long",
                                  "mask batch", "2-D", "devices"])
def test_wrapper_refuses_bad_inputs(what):
    dist, active = distances(2, 8, [5, 8])
    bad = {"float64": (dist.double(), active),
           "int8 mask": (dist, active.to(torch.int8)),
           "float mask": (dist, active.float()),
           "non-square": (dist[:, :, :7], active),
           "mask too long": (dist, torch.ones((2, 9), dtype=torch.bool)),
           "mask batch": (dist, active[:1]),
           "2-D": (dist[0], active[0]),
           "devices": (dist, active.to("meta"))}[what]
    with pytest.raises(ValueError):
        cluster.agglomerative_two(*bad)


def test_k3_is_one_of_the_ports_kernels():
    k3 = cluster.CLUSTER_KERNEL
    assert k3 in kernels.all_kernels()
    assert os.path.isfile(os.path.join(kernels.CSRC_DIR, k3.source))
    # the twin's products, sums and quotient round one by one
    assert "-fmad=false" in k3.flags


# ---- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def assert_k3_is_the_twin(dist, active, dev):
    dist, active = dist.to(dev), active.to(dev)
    before = cluster.CLUSTER_KERNEL.launches
    got = cluster.agglomerative_two(dist, active)
    assert cluster.CLUSTER_KERNEL.launches == before + 1
    want = cluster.agglomerative_two_ref(dist, active)
    assert torch.equal(got, want), (
        f"{int((got != want).any(1).sum())} images differ")


@pytest.mark.gpu
@pytest.mark.parametrize("na", [0, 1, 2, 3, 40, 230, 234, 235, 512])
@pytest.mark.parametrize("b", [1, 5, 32])
def test_k3_matches_the_twin(cuda, b, na):
    assert_k3_is_the_twin(*distances(b, 512, [na] * b, seed=na + b), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "ties", "nan", "asymmetric",
                                  "huge"])
def test_k3_matches_the_twin_on_every_kind(cuda, kind):
    """One launch mixing shared-memory and global images, every kind."""
    counts = [0, 3, 17, 64, 120, 234, 235, 300, 511, 512]
    assert_k3_is_the_twin(*distances(len(counts), 512, counts, seed=7,
                                     kind=kind), cuda)
    for n in (5, 33, 64):
        assert_k3_is_the_twin(*distances(6, n, [n, n - 1, n // 2, 2, 1, 0],
                                         seed=n, kind=kind), cuda)


@pytest.fixture(scope="module")
def cell():
    """A batch of the cell sd640_scenes_b32 on the card: its splits'
    inputs and the EM's inputs, recorded, the EM op by op (a replayed
    graph calls nothing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    step, batch = cell_batch(torch.device("cuda"))
    with em_op_by_op(), \
            recording(cluster, "agglomerative_two") as splits, \
            recording(consensus, "expectation_maximisation") as ems:
        step(batch)["hp1"].cpu()
    return splits, ems


@pytest.mark.gpu
def test_k3_matches_the_twin_on_the_cells_splits(cell, cuda):
    splits, _ = cell
    assert splits
    for dist, active in splits:
        assert_k3_is_the_twin(dist, active, cuda)


@pytest.mark.gpu
def test_em_result_with_k3_equals_the_twins(cell, cuda, monkeypatch):
    """The EM on the cell batch's inputs, op by op: K3's result is the
    twin's, field for field, with one K3 launch per split. (The counter
    ``em.cluster_launches`` is checked in ``test_torch_tracing.py``, and
    K3 inside the EM's graphs in ``test_torch_em_graph.py``: a trace
    session here would run before the profiler-based tests of
    ``test_torch_cuda_kernels.py``.)"""
    _, ems = cell
    monkeypatch.setattr(tem, "GRAPH_DEVICES", ())
    for args in ems:
        before = cluster.CLUSTER_KERNEL.launches
        with recording(tem, "_split_best_vp", clone=False) as splits:
            got = tem.expectation_maximisation(*args)
        assert splits
        assert cluster.CLUSTER_KERNEL.launches - before == len(splits)
        with monkeypatch.context() as m:
            m.setattr(cluster, "agglomerative_two",
                      cluster.agglomerative_two_ref)
            want = tem.expectation_maximisation(*args)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, **SAME)
