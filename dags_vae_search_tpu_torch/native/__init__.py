"""The host C++ edge codec (``fast_codec.cpp``), built at first use.

Counterpart of ``dags_vae_search_tpu/native/``.  :func:`load` compiles the
source with ``g++ -O3 -shared -fPIC -std=c++17`` into ``build/native/`` at
the repository root (git-ignored, named by a hash of the source and the
flags, so an edited source is rebuilt), loads it with ``ctypes`` and returns
it, or returns None when it cannot be built or loaded; ``build_log`` then
says why.  ``graphs/codec.py`` decodes through it when it loads and through
numpy otherwise.  Nothing is built when the module is imported.

:func:`decode_edges` and :func:`encode_edges` call the library on numpy
arrays.  They pass each column's address (``c_void_p``) and keep the arrays
alive for the call; nothing is copied into Python bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("fast_codec.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
#: the compiler's output of this process's build, or why :func:`load` gave None
build_log = ""


def _build() -> Path:
    """The library of the current source, compiled unless already built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libfast_codec_{digest[:12]}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: put g++ on PATH or set CXX")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    global build_log
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{build_log}")
    os.replace(tmp, lib)
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The codec library, built first if needed; None if that fails (the
    JAX package's contract).  The outcome is kept for the process."""
    global _lib, _tried, build_log
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        build_log = f"{build_log}\n{type(exc).__name__}: {exc}".strip()
        return None
    lib.decode_edges.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.decode_edges.restype = None
    lib.encode_edges.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.encode_edges.restype = None
    _lib = lib
    return _lib


def _library(lib: Optional[ctypes.CDLL]) -> ctypes.CDLL:
    lib = lib if lib is not None else load()
    if lib is None:
        raise RuntimeError(f"the native codec is not available: {build_log}")
    return lib


def decode_edges(
    bits: Mapping[int, np.ndarray], n: int, rows: int, lib: Optional[ctypes.CDLL] = None
) -> np.ndarray:
    """``adj`` float32[rows, n, n] from the edge columns: ``bits[i]``
    (i = 1..n-1) holds the ``rows * i`` ASCII '0'/'1' bytes of column
    ``e{i}``, any shape; ``adj[:, :i, i] = bits - ord("0")``."""
    lib = _library(lib)
    cols = {i: np.ascontiguousarray(bits[i], dtype=np.uint8) for i in range(1, n)}
    for i, col in cols.items():
        if col.size != rows * i:
            raise ValueError(f"column e{i} has {col.size} bytes, want rows * i = {rows * i}")
    ptrs = (ctypes.c_void_p * max(n, 1))()
    for i, col in cols.items():
        ptrs[i] = col.ctypes.data
    adj = np.empty((rows, n, n), dtype=np.float32)
    lib.decode_edges(ptrs, n, rows, adj.ctypes.data)
    return adj


def encode_edges(adj: np.ndarray, lib: Optional[ctypes.CDLL] = None) -> Dict[int, np.ndarray]:
    """The edge columns of ``adj`` [rows, n, n]: ``{i: uint8[rows, i]}`` for
    i = 0..n-1, ``'1'`` where ``adj[:, j, i] > 0`` and ``'0'`` elsewhere
    (what ``graphs.codec.encode_bits`` gives column by column)."""
    lib = _library(lib)
    adj = np.ascontiguousarray(adj, dtype=np.float32)
    rows, n, _ = adj.shape
    out = {i: np.empty((rows, i), dtype=np.uint8) for i in range(n)}
    ptrs = (ctypes.c_void_p * max(n, 1))()
    for i in range(1, n):
        ptrs[i] = out[i].ctypes.data
    lib.encode_edges(adj.ctypes.data, n, rows, ptrs)
    return out
