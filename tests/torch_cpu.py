"""The port's tests' CPU instruments, each defined once.

* :func:`torch_threads`: the thread policy of every
  ``tests/test_torch_*.py``, which takes it by importing the fixture
  (``from torch_cpu import torch_threads  # noqa: F401``): PyTorch's
  intra-op pool at one thread for the module's tests, and
  ``OMP_NUM_THREADS=1`` for the processes they start. The port's EM, its
  CPU detector and its tools are thousands of small ops; under the suite's
  parallel workers, each with PyTorch's full pool on every core, the
  pools' waits multiplied their time (one case ran 270x its
  single-process time). ``test_torch_pipeline.py`` checks that every port
  module takes it.
* :func:`truth_value_reads`: a count of the host's truth-value reads of
  tensors, the witness that the EM's own count of its host reads (the
  counter ``em.host_reads``) is held to.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

THREADS = 1


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """PyTorch's intra-op pool at :data:`THREADS` and ``OMP_NUM_THREADS``
    set to it for the importing module's tests; both restored after."""
    n = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(THREADS))
        torch.set_num_threads(THREADS)
        try:
            yield
        finally:
            torch.set_num_threads(n)


@contextlib.contextmanager
def truth_value_reads():
    """Count the host's reads of the truth value of a tensor inside the
    block, from any thread, by patching ``torch.Tensor.__bool__`` for the
    process; yields a dict whose ``"n"`` holds the count."""
    n = {"n": 0}
    orig = torch.Tensor.__bool__

    def counting(t):
        n["n"] += 1
        return orig(t)

    torch.Tensor.__bool__ = counting
    try:
        yield n
    finally:
        torch.Tensor.__bool__ = orig
