"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

The sources are ``asr_craft_tpu_torch/csrc/*.cu`` with a plain C interface
(no PyTorch headers, so a build takes seconds), and the headers they share,
``csrc/*.cuh``.  Each source is compiled by its own nvcc process, all
started together, and the objects are linked into one shared library, which
goes to ``asr_craft_tpu_torch/_build/``
(listed in .gitignore) under a name that hashes the sources, the headers
and the flags, so an edited source or header is rebuilt and an unchanged
tree is loaded as it is.  Nothing here runs at import time.

Also here: the checks every kernel wrapper makes before a launch
(:func:`check_tensor`) and after it (:func:`raise_on_error`).
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
build_info = {}      # {"seconds": ..., "log": ...} of the build, if one ran


def sources(csrc: Path = CSRC_DIR) -> list:
    """The translation units nvcc compiles."""
    return sorted(csrc.glob("*.cu"))


def headers(csrc: Path = CSRC_DIR) -> list:
    """The headers the sources include (hashed, not compiled alone)."""
    return sorted(csrc.glob("*.cuh"))


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


def nvcc_command(src, obj, nvcc: str = "nvcc") -> list:
    """The nvcc command line that compiles one source into the object
    ``obj``."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs, out, nvcc: str = "nvcc") -> list:
    """The nvcc command line that links ``objs`` into the library ``out``."""
    return [nvcc, "-shared", "-o", str(out), *(str(o) for o in objs)]


def library_path(csrc: Path = CSRC_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(csrc) + headers(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libasr_craft_kernels_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    nvcc = find_nvcc()
    objs = {src: tmp.with_name(f"{tmp.stem}.{src.stem}.o")
            for src in sources()}
    t0 = time.perf_counter()
    # one nvcc per source, all started together; then one link
    cmds = [nvcc_command(src, obj, nvcc) for src, obj in objs.items()]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    cmds.append(link_command(objs.values(), tmp, nvcc))
    log = ""
    try:
        for cmd, proc in zip(cmds, procs):
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed ({link.returncode}):\n"
                               f"{' '.join(cmds[-1])}\n"
                               f"{link.stdout}{link.stderr}")
        # atomic publish: concurrent builds each write their own tmp file
        os.replace(tmp, path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs.values():
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, log=log)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.fdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fdt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_tensor(name: str, t, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D ``dtype`` tensor on the
    CUDA ``device``: what a kernel takes."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the kernel "
                         f"(got {t.device}); use the 'torch' backend on CPU")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D {dtype}, got "
                         f"{t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if code != 0:
        msg = load_library().fdt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
