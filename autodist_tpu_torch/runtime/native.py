"""Build the host C++ sources in ``native/`` at first use.

The port's counterpart of ``autodist_tpu/runtime/nativelib.py`` for its
two libraries, the data-IO reader (``native/dataio.cc``) and the
coordination service (``native/coord.cc``): the host compiler
(``$CXX``, else ``g++``) builds each into ``runtime/_build/``
(git-ignored) under a name that carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
Every library gets :data:`CXX_FLAGS`, and a library named in
:data:`LIB_FLAGS` its own flags after them (``-pthread`` for the
coordination service's threads, as the JAX package's Makefile gives
it).  A missing compiler or a failed build raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LIB_FLAGS = {"coord": ("-pthread",)}

_lock = threading.Lock()
_loaded: dict = {}


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") \
        or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler ($CXX, g++ or c++): the "
                           "native libraries cannot be built")
    return cxx


def build(name: str) -> Path:
    """``lib<name>_<hash>.so`` from ``native/<name>.cc``, compiled unless
    this exact build exists; returns its path."""
    src = NATIVE_DIR / f"{name}.cc"
    flags = (*CXX_FLAGS, *LIB_FLAGS.get(name, ()))
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    lib = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    cxx = find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        staged = Path(tmp) / lib.name
        out = subprocess.run([cxx, *flags, "-o", str(staged), str(src)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"native build of {src.name} failed "
                               f"(rc={out.returncode}):\n{out.stderr}")
        os.replace(staged, lib)          # atomic: readers never see half
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cc``, built on first call (once a
    process)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
