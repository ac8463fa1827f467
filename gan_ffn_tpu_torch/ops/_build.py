"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled for Hopper only (``sm_90a``) into ``build/kernels/`` at the root of
the checkout, at first use -- never when a module is imported, so the CPU
tests import everything without a CUDA toolchain.  A library's file name
carries a digest of its source, of every header under ``csrc/`` that it
includes (``#include "..."``, followed through headers), and of the compiler
flags, so an edited ``.cu`` or ``.cuh`` rebuilds and a stale library is
never loaded.  :func:`build` starts one
``nvcc`` per missing library, all at once.

Every C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero code into a ``RuntimeError``.  A launch that CUDA refuses
(too much shared memory, a bad grid) never runs, and nothing else would
report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_functions: Dict[tuple, ctypes._CFuncPtr] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(src: Path) -> List[Path]:
    """The headers beside ``src`` that it includes, directly or through
    another header, in the order first met."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        current = todo.pop(0)
        for name in _INCLUDE.findall(current.read_bytes()):
            header = (current.parent / name.decode()).resolve()
            if header.is_file() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME); the port's "
        "CUDA kernels are built from gan_ffn_tpu_torch/csrc at first use"
    )


build_seconds: Dict[str, float] = {}  # library -> wall seconds of its last nvcc in this process
build_logs: Dict[str, str] = {}  # library -> that nvcc's output (ptxas -v resource lines)


def _compile(name: str, src: Path, target: Path) -> Tuple[str, int, str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode == 0:
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    return name, proc.returncode, proc.stdout, seconds


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) whose library is missing.

    One ``nvcc`` process per source, all started together; returns
    name -> library path.  Each compiled library's wall seconds and
    ``ptxas`` resource lines land in :data:`build_seconds` and
    :data:`build_logs`.  Raises ``RuntimeError`` with the compiler's output
    if any build fails.
    """
    srcs = sources()
    wanted = list(srcs) if names is None else list(names)
    missing = [n for n in wanted if n not in srcs]
    if missing:
        raise KeyError(f"no CUDA source for {missing} in {CSRC}")
    jobs = [(name, srcs[name], _library_path(srcs[name])) for name in wanted]
    jobs = [job for job in jobs if not job[2].exists()]
    errors = []
    if jobs:
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            for name, code, log, seconds in pool.map(lambda job: _compile(*job), jobs):
                if code != 0:
                    errors.append(f"--- {name}.cu (nvcc exit {code}):\n{log}")
                else:
                    build_seconds[name] = seconds
                    build_logs[name] = log
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {name: _library_path(srcs[name]) for name in wanted}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_resources(log: str) -> List[dict]:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: its mangled name,
    registers a thread and spill bytes."""
    out: List[dict] = []
    for line in log.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            out.append({"kernel": m.group(1)})
        elif out and (m := _PTXAS_SPILL.search(line)):
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif out and (m := _PTXAS_REGS.search(line)):
            out[-1]["registers"] = int(m.group(1))
    return out


def function(
    name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int
) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name``, built and loaded on
    first use, with its ``argtypes`` and ``restype`` set."""
    key = (name, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _functions[key] = fn
        return fn


def check(code: int, name: str) -> None:
    """Raise if a C entry of kernel library ``name`` returned a CUDA error."""
    if code != 0:
        describe = function(
            name, f"gan_{name}_error_string", [ctypes.c_int], ctypes.c_char_p
        )
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({describe(code).decode()})")
