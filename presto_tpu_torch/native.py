"""Build and load the hand-written CUDA kernels of the port (csrc/*.cu).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface, at first use, into `presto_tpu_torch/_build/` (listed in
.gitignore). The library name carries a hash of its source, so an edited
kernel is rebuilt and a stale one is never loaded. All missing libraries
are built together, one `nvcc` process per source started at once.

Every entry point returns the `cudaError_t` of its launches; wrappers pass
it to `check`, which raises on anything but success.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

#: rows handled by one block of the compaction kernel (csrc/compact.cu)
COMPACT_TILE = 2048

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64

#: library name -> {exported function: argtypes}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "direct_agg": {"direct_agg": [_P, _P, _I64, _P]},
    "compact": {"compact_indices": [_P, _I64, _P, _P, _P, _P, _P]},
    "segment_reduce": {
        "segment_reduce": [_P, _I32, _I32, _P, _P, _P, _I64, _I64,
                           _P, _P, _P, _P, _P, _P]},
    "hash": {"hash_columns": [_P, _P, _P, _I32, _I64, _P, _P]},
    "join": {
        "join_probe": [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _I32, _I32,
                       _P, _P, _P, _P, _P],
        "join_expand": [_P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P, _I32,
                        _I64, _P, _P, _P, _P, _P, _P, _P]},
    "seg_scan": {
        "segmented_scan": [_P, _I32, _I32, _I32, _P, _I64, _P, _P, _P, _P]},
    "keys": {
        "key_change": [_P, _I64, _P, _P, _P, _I32, _P, _P, _P, _I32, _I32,
                       _I32, _P, _P, _P]},
    "window": {"window_frame": [_P, _P, _P, _I64, _P]},
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/*.cu with the CUDA toolkit")


def _library_path(name: str) -> Path:
    # the shared headers are part of every library's source
    source = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named kernel libraries (default: all) that are not built
    yet, all `nvcc` processes at once. Returns per library its path, the
    seconds its build took (0 if it was already built) and the compiler's
    report (registers, shared memory, spills)."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0,
                         "report": path.with_suffix(".log").read_text()
                         if path.with_suffix(".log").exists() else ""}
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, path)
    failed = []
    for name, (proc, t0, tmp, path) in procs.items():
        report, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{report}")
            continue
        path.with_suffix(".log").write_text(report)
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": secs, "report": report}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building every library that is
    not built yet on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    built = build([n for n in SIGNATURES if n not in _LIBS])
    lib = ctypes.CDLL(built[name]["path"])
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str, lib_name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = load(lib_name).kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
