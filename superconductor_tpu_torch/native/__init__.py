"""Native host-side codecs: the port's copy of ``superconductor_tpu/native``.

``libscnative.so`` is built from the C++ sources in ``src/`` (BPTC BC6H/BC7,
ASTC LDR/HDR, ETC1S block decode, meshopt vertex/index decode, and the
frame-state code framestate.cpp: draws, joint FK, channel sampling) with
g++ at first use, into the repository's ``build/`` directory. The build writes a
temporary file and renames it into place, so processes that build at once
(parallel test workers) never load a half-written library.

Unlike the reference there is no OpenGL decode oracle behind it: when the
library cannot be built, ``load_native`` raises, and so does every decode
that needs it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build"
)
LIB_PATH = os.path.join(BUILD_DIR, "libscnative.so")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")
_lib = None


def _sources() -> list:
    return sorted(
        os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR)
        if f.endswith((".cpp", ".h"))
    )


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(f) > lib_mtime for f in _sources())


def build_native() -> str:
    """Compile src/*.cpp into build/libscnative.so; returns its path."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("scnative: no C++ compiler (g++) to build the host codecs")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cpp = [f for f in _sources() if f.endswith(".cpp")]
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, *cpp, "-o", tmp], capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"scnative build failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load_native():
    """The C++ library, building it first when it is missing or older than
    its sources. Raises when it cannot be built or loaded."""
    global _lib
    if _lib is None:
        if _stale():
            build_native()
        _lib = ctypes.CDLL(LIB_PATH)
    return _lib
