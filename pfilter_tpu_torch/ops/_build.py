"""Build and load the port's CUDA kernels (``pfilter_tpu_torch/csrc/*.cu``).

At first use every source is compiled with ``nvcc`` for ``sm_90a`` into an
object (all compilers run at once), the objects are linked into one shared
library with a plain C interface, and the library is loaded with ``ctypes``.
The build lands in ``pfilter_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources, the headers they include from ``csrc/`` and the flags, so an
unchanged tree reuses it and an edited one rebuilds.  A failed build raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libpfilter_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
# C functions of the library and their argument types (pointers and the
# stream as void*, ints as int, floats as float); ``load`` declares them, a
# test holds them against the sources' signatures.
VP, CI, CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "pf_knn_tiled": [VP, CI, VP, VP, VP, VP, VP, CI, CI, CI, CI, CI, VP, VP, VP],
    "pf_pca_radius": [VP, CI, VP, VP, VP, VP, CI, CI, CI, CF, CF, CI, VP, VP],
    "pf_work_list": [VP, CI, CI, VP, VP],
}

_lib = None
BUILD_INFO: dict = {}  # seconds, path, compiler log of the build this process loaded


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def sources(csrc: Path = CSRC) -> list:
    return sorted(csrc.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for flag in ARCH_FLAGS + CFLAGS:
        h.update(flag.encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build_key(csrc: Path = CSRC) -> str:
    """The build's key: the sources, the headers beside them and the flags."""
    return _digest(sources(csrc) + sorted(csrc.glob("*.cuh")))


def build(csrc: Path = CSRC, root: Path = BUILD_ROOT) -> Path:
    """Compile the ``*.cu`` files of ``csrc`` if their build under ``root``
    is missing; return the library path."""
    srcs = sources(csrc)
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    out_dir = root / build_key(csrc)
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        BUILD_INFO.update(seconds=0.0, path=str(lib_path), log="(cached)")
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(s), "-o", str(obj)]
            procs.append((s, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, objs = [], []
        for s, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {s.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
            objs.append(str(obj))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    log = "\n".join(logs)
    (out_dir / "build.log").write_text(log)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib_path), log=log)
    return lib_path


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process and declare
    each C function's argument types."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = CI
        _lib = lib
    return _lib
