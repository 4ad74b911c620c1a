"""The port's own LSD source and the name of its library: the copy is the
JAX package's source byte for byte, and a library built with
``-march=native`` is named after the host CPU, and every library after
the g++ that built it, so a ``build/`` carried to another machine rebuilds
instead of loading code made for the first."""

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


def test_library_name_follows_the_compiler(monkeypatch):
    """Faked g++ versions give other library names, with the native flags
    and without them: a library another g++ built is never loaded."""
    portable = ("-O3", "-shared", "-fPIC")
    names = set()
    for gxx in (b"g++ A", b"g++ B"):
        monkeypatch.setattr(hostbuild, "compiler", lambda g=gxx: g)
        names |= {tlsd._lib_path(), hostbuild.library_path(
            tlsd.SOURCE, portable, tlsd.BUILD_DIR, "liblsd")}
    assert len(names) == 4


def test_carried_builds_give_this_hosts_segments(tmp_path):
    """``scripts/compare_lsd_flags.py``: the libraries ``--export`` writes,
    read back by ``--carried`` on the same host, give the segments of the
    builds made here under every flag set (P1026), the source is the JAX
    package's and the grayscale image the same; and a build without fused
    multiply-adds keeps bundled scene 1's endpoints to 1e-9 of the JAX
    binding's flags (LSD's docstring: 3.4e-13 px apart on an FMA host)."""
    import importlib.util

    from vanishing_points_2017_tpu_torch.data import io as dio

    spec = importlib.util.spec_from_file_location(
        "compare_lsd_flags",
        os.path.join(ROOT, "scripts", "compare_lsd_flags.py"))
    cmp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cmp)
    cmp.export(str(tmp_path))
    out = cmp.compare(str(tmp_path))
    assert out["same_source"] and out["same_gray"]
    assert out["host"] == out["carried_host"]
    assert set(out["rows"]) == set(cmp.VARIANTS)
    for row in out["rows"].values():
        assert row["n_here"] == row["n_carried"] > 0
        assert row["here_carried"] == 0.0
    assert cmp._build("native") == tlsd._lib_path()
    img = dio.rgb2gray(dio.load_image(os.path.join(
        ROOT, "assets", "examples", "scene_1.png"))) * 255.0
    other = cmp.detect(cmp._build("nocontract"), img)
    native = tlsd.detect_line_segments(img)
    assert other.shape == native.shape
    np.testing.assert_allclose(other[:, :4], native[:, :4], rtol=0, atol=1e-9)
