"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C entry point. It is compiled with
``nvcc`` for Hopper (sm_90a) into ``build/kernels/<name>-<hash>.so`` beside
the package at first use, and loaded with ctypes; the hash covers the
source, the ``csrc`` headers it includes and the flags, so an edit to any
of them is rebuilt. ``build_all`` starts
one ``nvcc`` per source at once.

Every wrapper that launches a kernel calls ``count_launch``, which adds one
to ``launch_counts[name]`` and to ``launch_shapes[(name, shape, cout)]``, so
a run can show which kernels its path went through, and at which shapes; a
launch from an autograd backward also adds one to ``backward_counts[name]``
and to ``backward_shapes[(name, shape, cout)]``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNEL_SOURCES = ("conv3x3", "fir_resample2x")

launch_counts: collections.Counter = collections.Counter()
launch_shapes: collections.Counter = collections.Counter()
backward_counts: collections.Counter = collections.Counter()
backward_shapes: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, Callable[..., int]] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly or
    through another header."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for header in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            if (CSRC / header).exists() and CSRC / header not in found:
                found.append(CSRC / header)
    return found


def _target(name: str) -> Path:
    """The library's path, named by a hash of its sources and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all at once.
    Returns each source's ptxas report (empty for one already built) and
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        output, _ = proc.communicate()
        reports[name] = output
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all([name])
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes) -> Callable[..., int]:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, declared to take
    ``argtypes`` and to return the launch's cudaError_t."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def count_launch(name: str, shape: tuple, cout=None, backward: bool = False) -> None:
    """One launch of kernel ``name`` on an input of ``shape`` (and ``cout``
    output channels, for a kernel that changes them), made by an autograd
    backward where ``backward``."""
    key = (name, tuple(shape), cout)
    launch_counts[name] += 1
    launch_shapes[key] += 1
    if backward:
        backward_counts[name] += 1
        backward_shapes[key] += 1


def reset_counts() -> None:
    for counter in (launch_counts, launch_shapes, backward_counts, backward_shapes):
        counter.clear()

