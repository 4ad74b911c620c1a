"""The port's own LSD source and the name of its library: the copy is the
JAX package's source byte for byte, and a library built with
``-march=native`` is named after the host CPU, so a ``build/`` carried to
another machine rebuilds instead of loading code made for the first."""

import os

import numpy as np

from vanishing_points_2017_tpu_torch import hostbuild, lsd as tlsd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lsd_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(ROOT, "vanishing_points_2017_tpu", "lsd",
                           "lsd.cpp"), "rb") as f:
        jax_src = f.read()
    with open(tlsd.SOURCE, "rb") as f:
        assert f.read() == jax_src
    assert tlsd.SOURCE == os.path.join(ROOT, "vanishing_points_2017_tpu_torch",
                                       "csrc", "lsd.cpp")
    assert "-march=native" in tlsd.FLAGS


def test_library_name_follows_the_host_cpu(monkeypatch):
    """Faked CPU identities give other library names for the native flags,
    and leave a library built without them alone."""
    here = tlsd._lib_path()
    assert here == hostbuild.library_path(tlsd.SOURCE, tlsd.FLAGS,
                                          tlsd.BUILD_DIR, "liblsd")
    portable = ("-O3", "-shared", "-fPIC")
    names = {}
    for cpu in (b"cpu A", b"cpu B"):
        monkeypatch.setattr(hostbuild, "native_target", lambda c=cpu: c)
        names[cpu] = (tlsd._lib_path(), hostbuild.library_path(
            tlsd.SOURCE, portable, tlsd.BUILD_DIR, "liblsd"))
    assert len({names[b"cpu A"][0], names[b"cpu B"][0], here}) == 3
    assert names[b"cpu A"][1] == names[b"cpu B"][1]


def test_native_target_is_gxx_resolution_of_march_native():
    target = hostbuild.native_target()
    assert b"-march=" in target and target == hostbuild.native_target()
    tlsd.detect_line_segments(np.zeros((16, 16)))
    assert os.path.isfile(tlsd._lib_path())
