"""Native (C++) host runtime components of the port, built lazily.

`_hashobj.cpp` (the same source as the JAX package's) hashes the raw
scheduling-relevant pod subtree in one call (`pod_sig`), which keys pod
scheduling groups in `simulator/encode.py scheduling_signature`. Raw hashing
splits groups the computed tuple would merge ("1" vs "1000m" cpu, another
container name), so the port must take the same path as the reference to
partition a batch the same way.

The extension is compiled on first use with the host's C++ compiler (`CXX`,
default `g++`) against the running Python's headers, into
`build/native/` at the root of the checkout (ignored by git), named by a
digest of the source, the compiler and the Python version, so an edited
source never loads a stale binary. Concurrent builds (test workers) write
to a private temporary file and rename it into place. `SIMON_NO_NATIVE=1`
turns the native path off, as in the JAX package; without a compiler the
port falls back to the computed tuple, where the JAX package falls back too.
`backend()` says which of the two paths is in use. Nothing runs at import.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import tempfile
import threading
from typing import Callable, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_hashobj.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")

_lock = threading.Lock()
_pod_sig: Optional[Callable] = None
_tried = False
_why = ""  # why the native path is off, when it is


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def so_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(f"{_cxx()} {sys.version}".encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"_hashobj-{h.hexdigest()[:16]}{suffix}")


def _build(out: str) -> bool:
    global _why
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_cxx(), "-O2", "-shared", "-fPIC", "-std=c++17",
           f"-I{sysconfig.get_paths()['include']}", _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        _why = f"the C++ compiler did not run: {e}"
        os.unlink(tmp)
        return False
    if proc.returncode != 0:
        _why = f"the C++ build failed: {proc.stderr.strip()[-400:]}"
        os.unlink(tmp)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return True


def _load(path: str):
    spec = importlib.util.spec_from_file_location("open_simulator_torch.native._hashobj", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ensure_built() -> None:
    global _pod_sig, _tried, _why
    with _lock:
        if _tried:
            return
        _tried = True
        if os.environ.get("SIMON_NO_NATIVE"):
            _why = "SIMON_NO_NATIVE is set"
            return
        try:
            out = so_path()
            if not os.path.exists(out) and not _build(out):
                logging.debug("native hash unavailable: %s", _why)
                return
            _pod_sig = _load(out).pod_sig
        except Exception as e:  # any failure: the computed-tuple path, as in JAX
            _why = f"the native extension did not load: {e}"
            logging.debug("native hash unavailable: %s", _why)
            _pod_sig = None


def pod_sig_fn() -> Optional[Callable]:
    """The native one-call pod-signature function (extraction + hash),
    building it on the first call; None when the native path is off."""
    _ensure_built()
    return _pod_sig


def backend() -> str:
    """"native" or "computed (<why>)": the signature path in use."""
    _ensure_built()
    return "native" if _pod_sig is not None else f"computed ({_why})"
