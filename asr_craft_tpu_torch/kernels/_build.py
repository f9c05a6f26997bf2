"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

The sources are ``asr_craft_tpu_torch/csrc/*.cu`` with a plain C interface
(no PyTorch headers, so a build takes seconds).  The shared library goes to
``asr_craft_tpu_torch/_build/`` (listed in .gitignore) under a name that
hashes the sources and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
build_info = {}      # {"seconds": ..., "log": ...} of the build, if one ran


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def nvcc_command(srcs, out, nvcc: str = "nvcc") -> list:
    """The nvcc command line that builds ``srcs`` into the library ``out``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(s) for s in srcs)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libasr_craft_kernels_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = nvcc_command(sources(), tmp, find_nvcc())
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    # atomic publish: concurrent builds each write their own tmp file
    os.replace(tmp, path)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        _lib = ctypes.CDLL(str(path))
    return _lib
