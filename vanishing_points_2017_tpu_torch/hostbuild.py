"""Build the port's host-side C++ sources (the LSD detector, the JPEG
entropy coder) into shared libraries with g++, at first use.

A library goes into a directory under ``build/`` of the checkout, under a
name hashed from its source, its flags and the g++ that builds it, as
``kernels.py`` names the CUDA libraries: an edited source, or another
compiler, rebuilds, and a stale library is never loaded (two g++ versions
can compile the same floating-point source into code that rounds
differently). A library built with ``-march=native`` is compiled for the
host's CPU, so its name also hashes what ``-march=native`` resolves to
there: a ``build/`` carried to another machine rebuilds instead of loading
code made for the first. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess

NATIVE = "-march=native"


def _gxx(what: str) -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {what} is built at first use")
    return gxx


@functools.cache
def native_target() -> bytes:
    """This host's identity for ``-march=native``: the target options g++
    resolves it to (``g++ -march=native -Q --help=target``)."""
    return subprocess.run([_gxx("a -march=native library"), NATIVE, "-Q",
                           "--help=target"], capture_output=True,
                          check=True).stdout


@functools.cache
def compiler() -> bytes:
    """The g++ that builds the libraries (``g++ --version``)."""
    return subprocess.run([_gxx("a host library"), "--version"],
                          capture_output=True, check=True).stdout


def library_path(source: str, flags: tuple, build_dir: str,
                 stem: str) -> str:
    """Where the library of ``source`` built with ``flags`` by this g++
    lies (on this host, where ``flags`` hold ``-march=native``)."""
    with open(source, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(flags).encode())
    h.update(compiler())
    if NATIVE in flags:
        h.update(native_target())
    return os.path.join(build_dir, f"{stem}-{h.hexdigest()[:12]}.so")


def build_shared(source: str, flags: tuple, build_dir: str,
                 stem: str) -> str:
    """Compile ``source`` with g++ and ``flags`` into ``build_dir`` unless
    the library is there already; returns the library's path."""
    path = library_path(source, flags, build_dir, stem)
    if os.path.isfile(path):
        return path
    gxx = _gxx(source)
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *flags, source, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path
