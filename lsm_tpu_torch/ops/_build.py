"""Build and load the hand-written CUDA kernels (csrc/*.cu).

One shared library with a plain C interface, compiled by nvcc for sm_90a
at first use and loaded with ctypes (no PyTorch headers, so a build takes
seconds, not minutes). Each source compiles in its own nvcc process, all
started together, and one more nvcc links the objects. The library is keyed
by a hash of the sources and the flags: an edited kernel is never served
from a stale build. In a source checkout the output goes to
build/lsm_tpu_torch/ at the checkout's root (build/ is git-ignored); an
installed package builds into the user's cache directory instead of
site-packages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
import time
from pathlib import Path
from typing import Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():                 # a source checkout
        return root / "build" / "lsm_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "lsm_tpu_torch"


BUILD_DIR = _build_dir()
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of lsm_tpu_torch "
        "build from source at first use and need the CUDA toolkit"
    )


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):             # sources and headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build() -> Path:
    """Compile csrc/*.cu into BUILD_DIR/liblsm_kernels_<hash>.so unless
    that exact build exists. Returns the library path."""
    lib_path = BUILD_DIR / f"liblsm_kernels_{_digest()}.so"
    if lib_path.exists():
        _build_info.setdefault("path", str(lib_path))
        _build_info.setdefault("seconds", 0.0)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, sources())]
        # Link to a temp name and rename: a concurrent build never loads a
        # half-written library.
        so = Path(tmp) / lib_path.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so), *objs]
        with ThreadPoolExecutor(len(cmds)) as pool:             # one nvcc a source
            procs = list(pool.map(_run, cmds))
        procs.append(_run(link) if all(p.returncode == 0 for p in procs) else None)
        for cmd, proc in zip([*cmds, link], procs):
            if proc is not None and proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}\n{proc.stderr}")
        os.replace(so, lib_path)
    dt = time.perf_counter() - t0
    report = "\n".join(p.stdout + p.stderr for p in procs)
    (BUILD_DIR / f"ptxas_{lib_path.stem}.log").write_text(report)
    _build_info.update(path=str(lib_path), seconds=dt, log=report)
    return lib_path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point with its argtypes set (pointers and the stream as
    c_void_p, so ctypes never truncates them to 32 bits). Every entry point
    returns cudaGetLastError() as an int."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build_info() -> dict:
    """Path, build seconds and the ptxas -v report of this process's build
    (seconds is 0 when an existing build was reused)."""
    return dict(_build_info)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        fn = library().lsm_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {fn(err).decode()}")
