"""Build and load the hand-written CUDA kernels of the port (csrc/*.cu).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface, at first use, into `presto_tpu_torch/_build/` (listed in
.gitignore). The library name carries a hash of its source, so an edited
kernel is rebuilt and a stale one is never loaded. All missing libraries
are built together, one `nvcc` process per source started at once.

Every entry point returns the `cudaError_t` of its launches; wrappers pass
it to `check`, which raises on anything but success.

The host codec of the spill frames (csrc/page_codec.cc: LZ4 block
compression and CRC32, a copy of presto_tpu/native/page_codec.cc) is
built the same way with `g++` at first use (`codec()`), and bound as the
JAX package binds it (`lz4_compress`, `lz4_decompress`, `crc32`).
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
from typing import Dict, Iterable, Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

#: rows of one tile of the compaction kernel (csrc/compact.cu CT_TILE);
#: the tests size their inputs by it
COMPACT_TILE = 4096

#: K3's schedule by segment length (csrc/segment_reduce.cu): a segment of
#: at most SEGMENT_SMALL_MAX rows takes one thread, one of at most
#: SEGMENT_WARP_MAX rows one warp, a longer one a block per piece of
#: SEGMENT_PIECE rows; the tests size their segments by them
SEGMENT_SMALL_MAX = 32
SEGMENT_WARP_MAX = 1024
SEGMENT_PIECE = 8192

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64

#: library name -> {exported function: argtypes}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "direct_agg": {"direct_agg": [_P, _P, _I64, _P]},
    "compact": {"compact_indices": [_P, _I64, _P, _P, _P, _P, _P]},
    "segment_reduce": {
        "segment_reduce": [_P, _I32, _I32, _P, _P, _P, _I64, _I64,
                           _P, _P, _P, _P, _P, _P, _P],
        "segment_sum128": [_P, _P, _P, _P, _I32, _P, _P, _P, _I64, _I64,
                           _P, _P, _P, _P],
        "segment_merge128": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                             _I64, _P, _P, _P, _P, _P]},
    "hash": {"hash_columns": [_P, _P, _P, _I32, _I64, _P, _P]},
    "join": {
        "join_probe": [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _I32, _I32,
                       _P, _P, _P, _P, _P, _P],
        "join_expand": [_P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P, _I32,
                        _I64, _P, _P, _P, _P, _P, _P]},
    "seg_scan": {
        "segmented_scan": [_P, _I32, _I32, _I32, _P, _I64, _P, _P, _P],
        "window_bounds": [_P, _P, _I64, _P, _P, _P, _P, _P, _P]},
    "keys": {
        "key_change": [_P, _I64, _P, _P, _P, _I32, _P, _P, _P, _I32, _I32,
                       _I32, _P, _P, _P]},
    "window": {"window_frame": [_P, _P, _P, _I64, _P, _P]},
    "int128": {"int128_op": [_P, _P]},
    "unnest": {
        "unnest_expand": [_P, _P, _I32, _I64, _P, _I64, _I64, _P, _P, _P,
                          _P, _P, _P, _P, _P]},
    "hll": {
        "hll_direct": [_P, _I32, _P, _P, _I64, _I32, _P, _P, _P, _P, _P],
        "hll_sorted": [_P, _I32, _P, _I64, _P, _P, _I64, _P, _P, _P, _P]},
    "percentile": {
        "segment_select": [_P, _I32, _P, _I64, _P, _I32, _P, _P, _I64,
                           ctypes.c_double, _P, _P, _P, _P]},
}

#: entry points that return the int64 words of scratch a launch takes, so
#: that the layout is written down in its .cu file alone
SCRATCH_SIGNATURES: Dict[str, Dict[str, list]] = {
    "direct_agg": {"direct_agg_scratch_words": [_P]},
    "compact": {"compact_scratch_words": [_I64]},
    "segment_reduce": {"segment_reduce_scratch_words": [_I64, _I64]},
    "join": {"join_probe_scratch_words": [_I64],
             "join_expand_scratch_words": [_I64, _I64]},
    "seg_scan": {"segmented_scan_scratch_words": [_I64]},
    "window": {"window_frame_scratch_words": [_P, _I64]},
    "unnest": {"unnest_expand_scratch_words": [_I64, _I64]},
    "hll": {"hll_scratch_words": [_I64, _I32]},
    "percentile": {"segment_select_scratch_words": [_I64, _I64, _I32]},
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
    for fn, argtypes in SCRATCH_SIGNATURES.get(name, {}).items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int64
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str, lib_name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = load(lib_name).kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# the host codec of spill frames (csrc/page_codec.cc)
# ---------------------------------------------------------------------------

_CODEC_LOCK = threading.Lock()
_CODEC: list = []          # [library or None] once tried


def codec() -> Optional[ctypes.CDLL]:
    """The page codec library, built with g++ into BUILD_DIR at first use
    (its name carries a hash of the source); None where it cannot be
    built or loaded."""
    if _CODEC:
        return _CODEC[0]
    with _CODEC_LOCK:
        if _CODEC:
            return _CODEC[0]
        src = CSRC / "page_codec.cc"
        flags = ("-O3", "-shared", "-fPIC")
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(flags).encode()).hexdigest()
        path = BUILD_DIR / f"libpage_codec-{digest[:12]}.so"
        lib = None
        try:
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
                subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.pt_crc32.restype = ctypes.c_uint32
            lib.pt_crc32.argtypes = [_P, ctypes.c_size_t, ctypes.c_uint32]
            for fn in ("pt_lz4_compress", "pt_lz4_decompress"):
                f = getattr(lib, fn)
                f.restype = ctypes.c_size_t
                f.argtypes = [_P, ctypes.c_size_t, _P, ctypes.c_size_t]
        except (OSError, subprocess.SubprocessError):
            lib = None
        _CODEC.append(lib)
        return lib


def lz4_compress(data) -> Optional[bytes]:
    """LZ4 block compress; None if the codec library is absent."""
    lib = codec()
    if lib is None:
        return None
    n = len(data)
    src = np.frombuffer(data, dtype=np.uint8)
    cap = n + n // 255 + 64
    out = np.empty(cap, dtype=np.uint8)
    got = lib.pt_lz4_compress(src.ctypes.data if n else None, n,
                              out.ctypes.data, cap)
    if got == 0:
        return None
    return out[:got].tobytes()


def lz4_decompress(data, uncompressed: int) -> Optional[bytes]:
    """LZ4 block decompress to the declared size; None on failure or if
    the codec library is absent."""
    lib = codec()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(uncompressed, 1), dtype=np.uint8)
    got = lib.pt_lz4_decompress(src.ctypes.data if len(src) else None,
                                len(src), out.ctypes.data, uncompressed)
    if got != uncompressed:
        return None
    return out[:uncompressed].tobytes()


def crc32(data, crc: int = 0) -> Optional[int]:
    """zlib-compatible CRC32; None if the codec library is absent."""
    lib = codec()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(lib.pt_crc32(buf.ctypes.data if len(buf) else None,
                            len(buf), crc & 0xFFFFFFFF))
