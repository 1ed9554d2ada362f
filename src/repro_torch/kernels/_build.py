"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source compiles at first use into a shared library with a plain C
interface, under ``kernels/_build/`` (git-ignored), and is loaded with
:mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel is never served from
a stale build.  A failed build raises
:class:`KernelBuildError`; there is no fallback.  :func:`build_all`
starts one ``nvcc`` per source at once, so a program that needs several
kernels pays for the slowest build, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["KernelBuildError", "KernelFault", "CSRC_DIR", "BUILD_DIR",
           "NVCC_FLAGS", "check_fault_word",
           "build_all", "load", "build_log", "require_hopper"]

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time (0.0 when already built),
#:          "ptxas": nvcc's stderr (registers, shared memory, spills)}
build_log: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelFault(RuntimeError):
    """A kernel reported a fault of its own after it ran."""


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (set NVCC, or put the CUDA toolkit's bin/ on PATH); "
        "the CUDA kernels are compiled at first use")


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise KernelBuildError(f"no kernel source {src}")
    # the shared headers too: a source that includes one is stale after it
    # changes
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: list[str]) -> dict[str, pathlib.Path]:
    """Compile every named source that is not built yet, all at once.

    Returns name -> library path.  Raises :class:`KernelBuildError` with
    the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, (src, lib) in targets.items():
        if lib.exists():
            build_log.setdefault(n, {"seconds": 0.0, "ptxas": ""})
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    failed = []
    for n, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)     # atomic: concurrent builds agree
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return {n: lib for n, (_, lib) in targets.items()}


def require_hopper(dev, name: str) -> None:
    """Raise unless ``dev`` is an sm_90 (Hopper) card, which the kernels
    are built for."""
    import torch
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(
            f"{name} kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(dev)} is sm_{cap[0]}{cap[1]}")


def check_fault_word(name: str, unchecked: set, bound: dict) -> None:
    """Raise :class:`KernelFault` if a ring wait of a launch of kernel
    ``name`` gave up (its give-up word, read and cleared through the
    library's ``<name>_faults`` entry, bound once into ``bound``) on a
    device of ``unchecked`` since the last check; empties ``unchecked``.
    Synchronizes those devices; does nothing when there are none."""
    import torch
    entry = f"{name}_faults"
    while unchecked:
        dev = unchecked.pop()
        fn = bound.get(entry)
        if fn is None:
            fn = getattr(load(name), entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int
            bound[entry] = fn
        word = ctypes.c_uint(0)
        with torch.cuda.device(dev):
            torch.cuda.synchronize(dev)
            err = fn(ctypes.byref(word), 1)
        if err != 0:
            raise RuntimeError(f"{name}: reading its fault word failed: "
                               f"CUDA error {err}")
        if word.value:
            raise KernelFault(
                f"{name}: an mbarrier wait gave up on {dev} (a TMA ring "
                f"fault); the outputs of its launches since the last check "
                f"are wrong")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
