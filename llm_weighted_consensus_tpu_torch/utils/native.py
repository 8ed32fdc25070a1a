"""Loader for the repository's native (C++) tokenizer library.

Counterpart of ``llm_weighted_consensus_tpu/utils/native.py``, kept as
this package's own copy.  ``native/*.cpp`` at the repository root (the
WordPiece and unigram tokenizers, and the SSE parser the port does not
use yet) compile into one shared library with ``g++ -O3 -std=c++17 -fPIC
-shared`` at first use.  The library goes to
``build/native/liblwc_native.so``; ``native/`` itself is never written.
It is rebuilt when a source is newer than it, written under a temporary
name and moved into place, so a concurrent loader never maps a
half-written file.

``LWC_NATIVE=0`` turns the native paths off.  Without a compiler the
library is missing and the tokenizers keep their Python path, which the
native one matches token for token: host code, not a device fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

REPO_DIR = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = REPO_DIR / "native"
BUILD_DIR = REPO_DIR / "build" / "native"
NATIVE_SO = BUILD_DIR / "liblwc_native.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def enabled() -> bool:
    """False when ``LWC_NATIVE`` turns the native paths off."""
    return os.environ.get("LWC_NATIVE", "1").lower() not in (
        "0", "false", "no",
    )


def sources() -> list:
    return sorted(NATIVE_DIR.glob("*.cpp"))


def _stale(srcs: list) -> bool:
    if not NATIVE_SO.exists():
        return True
    built = NATIVE_SO.stat().st_mtime
    return any(src.stat().st_mtime > built for src in srcs)


def build() -> Path:
    """Compile ``native/*.cpp`` into ``NATIVE_SO``; raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{NATIVE_SO.name}.{os.getpid()}.{threading.get_ident()}"
    subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, sources())],
        check=True, capture_output=True, timeout=300,
    )
    os.replace(tmp, NATIVE_SO)
    return NATIVE_SO


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built on first call; None when ``LWC_NATIVE=0``
    or when it cannot be built or loaded (remembered: no second try)."""
    global _lib, _tried
    if not enabled():
        return None
    with _lock:
        if not _tried:
            _tried = True
            try:
                srcs = sources()
                if srcs and _stale(srcs):
                    build()
                if NATIVE_SO.exists():
                    _lib = ctypes.CDLL(str(NATIVE_SO))
            except (OSError, subprocess.SubprocessError):
                _lib = None
        return _lib
