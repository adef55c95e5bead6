"""Build and load the port's CUDA kernels.

Each source in ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``build/`` at the repository root, and loaded with ``ctypes``.
The library's name carries a hash of its sources, so an edited source is
rebuilt and an unchanged one is reused.  :func:`build_all` starts one
``nvcc`` per source at once.

Nothing here runs when a module is imported: the CPU tests import every
module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: kernel library -> its translation unit in ``csrc/``
SOURCES: Dict[str, str] = {"ivf_scan": "ivf_scan.cu", "pq_scan": "pq_scan.cu",
                           "topk_merge": "topk_merge.cu",
                           "flash_attention": "flash_attention.cu",
                           "decode_attention": "decode_attention.cu",
                           "flash_attention_bwd": "flash_attention_bwd.cu",
                           "gather_scatter": "gather_scatter.cu"}

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build
ptxas_log: Dict[str, str] = {}


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one per launch, and a run
    reads the count to show that its path went through the kernel."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


#: receivers of the kernels' work while an operation count runs
#: (``launch/op_analysis.py``): each is called with a kernel's name, the
#: FLOPs and the bytes of the function one call computes
work_sinks: List[Callable[[str, float, float], None]] = []


def counting_work() -> bool:
    """True while an operation count runs: only then does a wrapper work
    out its call's ``work`` (decode's reads ``pos`` from the card)."""
    return bool(work_sinks)


def record_work(name: str, work: Tuple[float, float]) -> None:
    """Pass one call's (FLOPs, bytes) of kernel ``name`` to every
    receiver."""
    for sink in list(work_sinks):
        sink(name, *work)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernel libraries (default: all) that are not built
    yet, one ``nvcc`` process per source, all started together.  Raises
    with the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    out: Dict[str, Path] = {}
    for name in names:
        path = _lib_path(name)
        out[name] = path
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs.append((name, path, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, with each function of
    ``signatures`` given its ctypes argument types (pointers and the stream
    as ``c_void_p``, so they are not cut to 32 bits) and an ``int`` result:
    the ``cudaError_t`` of its launch."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``: a refused launch
    never runs, and a later synchronise would not report it."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
