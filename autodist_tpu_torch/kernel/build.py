"""Build the CUDA sources in ``csrc/`` into one shared library, at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (all sources at
once, one process each), links the objects into one ``.so`` with a
plain C interface, and :func:`load_library` opens it with ``ctypes``.
The library lives in ``kernel/_build/`` (git-ignored) under a name that
carries a hash of the sources and flags, so editing a source rebuilds
and an unchanged tree reuses the last build.  A failed build raises
with the compiler's output; nothing is downloaded and no other library
is needed.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source's name and content and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the first failure's
    output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode)
            for c, p in zip(cmds, procs)]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(
                f"kernel build failed (rc={rc}): {' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile and link the sources unless this exact build exists;
    returns the library's path."""
    lib = BUILD_DIR / f"libautodist_kernels_{source_hash()}.so"
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources(), objs)])
        staged = Path(tmp) / lib.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(staged),
                   *map(str, objs)]])
        os.replace(staged, lib)          # atomic: readers never see half
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    return ctypes.CDLL(str(build()))
