"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers) into ``build/<name>-<hash>.so``, where the hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags: a
changed source or header builds anew, an unchanged one loads what is there. :func:`build` starts one ``nvcc`` per
source, all together, and waits for them. The ``.so`` is loaded with
``ctypes``; each kernel module declares its own ``argtypes``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc`` at all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # replicas may launch a kernel first from two threads


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile every listed kernel whose library is missing.

    One ``nvcc`` per source, started together. Returns, for each kernel
    built, its wall seconds and the compiler's ``-Xptxas -v`` report
    (registers, shared memory, spills). Raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.monotonic()  # reprolint: disable=wallclock
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, t0)
    built: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.monotonic() - t0  # reprolint: disable=wallclock
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
        target.with_suffix(".log").write_text(log)
        built[name] = (seconds, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return built


def check_16b_layout(t, dims: Tuple[int, ...], what: str) -> None:
    """Raise unless ``t``'s base pointer and its strides along ``dims`` are
    whole multiples of 16 bytes: the kernels read and write 16 bytes a lane
    (``cp.async``, ``uint4`` loads and stores), and have no scalar path."""
    size = t.element_size()
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: base pointer not 16-byte aligned")
    for dim in dims:
        if (t.stride(dim) * size) % 16:
            raise ValueError(f"{what}: stride {t.stride(dim)} of dim {dim} is not a "
                             "multiple of 16 bytes (16-byte aligned rows needed)")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:  # one build per library (its temporary file is named by pid)
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib
