"""Native (C++) runtime components, compiled on demand with the system
toolchain and loaded via ctypes. Each has a pure-Python fallback so the
framework still runs without a compiler."""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}


def load_native(name: str) -> ctypes.CDLL | None:
    """Compile (once) and load lib<name>.so from <name>.cpp; None if the
    toolchain is unavailable or the build fails."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(_DIR, f"{name}.cpp")
        so = os.path.join(_BUILD_DIR, f"lib{name}.so")
        lib: ctypes.CDLL | None = None
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                # -march=native is safe by construction: the library is
                # compiled on demand on the machine that will run it
                cmd = [
                    "g++",
                    "-O3",
                    "-march=native",
                    "-std=c++17",
                    "-shared",
                    "-fPIC",
                    src,
                    "-o",
                    so,
                ]
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native %s unavailable (%s); using python fallback", name, e)
            lib = None
        _LIBS[name] = lib
        return lib
