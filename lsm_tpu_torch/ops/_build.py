"""Build and load the hand-written CUDA kernels (csrc/*.cu), the native
WAV decoder (csrc/wavio.cpp) and the serving engines' staging copy
(csrc/stage.cpp).

One shared library with a plain C interface, compiled by nvcc for sm_90a
at first use and loaded with ctypes (no PyTorch headers, so a build takes
seconds, not minutes). Each source compiles in its own nvcc process, all
started together, and one more nvcc links the objects. The library is keyed
by a hash of the sources and the flags: an edited kernel is never served
from a stale build. In a source checkout the output goes to
build/lsm_tpu_torch/ at the checkout's root (build/ is git-ignored); an
installed package builds into the user's cache directory instead of
site-packages.

The decoder and the staging copy are plain C++: g++ builds each at first
use with the JAX package's native/Makefile flags into the same directory,
keyed by a hash of the source, the flags, the compiler's version and the
host CPU's target flags (-march=native resolves per machine, and a
checkout may be copied to another host).

Every call of a C entry point goes through `Entry`: bound once at its first
call, and a kernel launched by `Entry.launch`, which counts it in
`launches`.
"""

from __future__ import annotations

import collections
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

import torch

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


# Kernel launches in this process by C entry point; lif.py's launches also
# count under '<entry point>:<body>'. Plain twins count nothing.
launches: collections.Counter = collections.Counter()


class Entry:
    """One C entry point of the kernel library, bound at its first call
    with its argtypes and restype set once (pointers and the stream as
    c_void_p, so ctypes never truncates them to 32 bits). Every kernel
    entry point takes the stream last and returns cudaGetLastError() as an
    int."""

    def __init__(self, name: str, argtypes: Sequence, restype=ctypes.c_int):
        self.name = name
        self._types = (list(argtypes), restype)
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(library(), self.name)
            fn.argtypes, fn.restype = self._types
            self._fn = fn
        return self._fn(*args)

    def launch(self, device: torch.device, *args, body: Optional[str] = None) -> None:
        """Launch on `device`'s current stream, raise if the launch was
        refused, and count it (also as '<name>:<body>' when `body` names
        the kernel body it ran on)."""
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}")
        with torch.cuda.device(device):
            err = self(*args, torch.cuda.current_stream(device).cuda_stream)
        check(err, self.name)
        launches[self.name] += 1
        if body is not None:
            launches[f"{self.name}:{body}"] += 1


_error_string = Entry("lsm_cuda_error_string", [ctypes.c_int], ctypes.c_char_p)


def build_info() -> dict:
    """Path, build seconds and the ptxas -v report of this process's build
    (seconds is 0 when an existing build was reused)."""
    return dict(_build_info)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {_error_string(err).decode()}")


WAVIO_SOURCE = CSRC_DIR / "wavio.cpp"
STAGE_SOURCE = CSRC_DIR / "stage.cpp"
# native/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
CXX_LDFLAGS = ("-shared", "-pthread")
_native_lock = threading.Lock()


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found: the native WAV decoder and the serving "
                           "staging copy build from source at first use")
    return found


def build_native(source: Path) -> Path:
    """Compile one plain C++ source of csrc/ into BUILD_DIR/lib<stem>_<hash>.so
    unless that exact build exists. Returns the library path."""
    cxx = _cxx()
    target = _run([cxx, "-march=native", "-Q", "--help=target"]).stdout
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS, *CXX_LDFLAGS)).encode())
    h.update(_run([cxx, "--version"]).stdout.encode())
    h.update(target.encode())
    h.update(source.read_bytes())
    lib_path = BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"
    with _native_lock:
        if lib_path.exists():
            return lib_path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            so = Path(tmp) / lib_path.name
            cmd = [cxx, *CXX_FLAGS, str(source), "-o", str(so), *CXX_LDFLAGS]
            proc = _run(cmd)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(so, lib_path)
    return lib_path


def build_wavio() -> Path:
    """The native WAV decoder's library (csrc/wavio.cpp)."""
    return build_native(WAVIO_SOURCE)
