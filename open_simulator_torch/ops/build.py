"""Build and load the CUDA kernels of csrc/ (nvcc → shared library → ctypes).

The library is compiled on first use for sm_90a with `--fmad=false` (no
contraction into fused multiply-adds: the kernels must round every operation
exactly as the plain PyTorch versions do) into `build/torch_kernels/` at the
root of the checkout, named by a digest of the sources and flags, so an edited
source never loads a stale binary. Each source compiles in its own nvcc
process, all started together, then one link makes the library. It has a
plain C interface and includes no PyTorch header, which keeps the build to
seconds. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", f)
           for f in ("schedule.cu", "wave.cu", "group_serial.cu", "affinity_wave.cu", "extend.cu",
                     "explain.cu")]
HEADERS = [os.path.join(_HERE, "csrc", f) for f in ("common.cuh", "select.cuh")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, if it built
ptxas_log: str = ""


def nvcc_path() -> str:
    """nvcc from CUDA_HOME (as PyTorch resolves it), else from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest(paths: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libschedule_{_digest(SOURCES + HEADERS)}.so")


def _run_all(cmds: List[List[str]]) -> List[subprocess.CompletedProcess]:
    """Run the commands at once; wait for every one of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    done = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        done.append(subprocess.CompletedProcess(c, p.returncode, out, err))
    return done


def compile_library() -> str:
    """Compile csrc/ into the shared library (if not already built); returns
    its path. Raises with nvcc's output when the build fails."""
    global build_seconds, ptxas_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in SOURCES]
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    try:
        compiled = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                             for s, o in zip(SOURCES, objs)])
        for proc in compiled:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {proc.args[-1]}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
        tmp = f"{out}.{tag}"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n"
                               f"{link.stderr}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_seconds = time.perf_counter() - t0
    ptxas_log = "".join(p.stderr for p in compiled)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(compile_library())
    return _lib


def _load(path: str) -> ctypes.CDLL:
    from .kernels import ExtArgs, TablesView

    lib = ctypes.CDLL(path)
    P = ctypes.c_void_p
    V = ctypes.POINTER(TablesView)
    lib.tables_view_size.argtypes = []
    lib.tables_view_size.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    lib.schedule_scratch_floats.argtypes = [V]
    lib.schedule_scratch_floats.restype = ctypes.c_longlong
    lib.feasibility_launch.argtypes = [V] + [ctypes.c_int] * 4 + [P] * 4
    lib.feasibility_launch.restype = ctypes.c_int
    lib.schedule_batch_launch.argtypes = [V, P, P, P, ctypes.c_int, P, P, P]
    lib.schedule_batch_launch.restype = ctypes.c_int
    lib.wave_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.wave_scratch_floats.restype = ctypes.c_longlong
    lib.wave_scratch_ints.argtypes = [ctypes.c_int]
    lib.wave_scratch_ints.restype = ctypes.c_longlong
    lib.schedule_wave_launch.argtypes = [V] + [ctypes.c_int] * 5 + [P] * 5
    lib.schedule_wave_launch.restype = ctypes.c_int
    lib.aggregate_commit_launch.argtypes = [V, ctypes.c_int, P, P, P, P, ctypes.c_int, ctypes.c_int,
                                            P, P]
    lib.aggregate_commit_launch.restype = ctypes.c_int
    lib.group_serial_scratch_floats.argtypes = [V]
    lib.group_serial_scratch_floats.restype = ctypes.c_longlong
    lib.group_serial_scratch_ints.argtypes = [V]
    lib.group_serial_scratch_ints.restype = ctypes.c_longlong
    lib.schedule_group_serial_launch.argtypes = ([V, ctypes.c_int, P] + [ctypes.c_int] * 4
                                                 + [P] * 5)
    lib.schedule_group_serial_launch.restype = ctypes.c_int
    lib.affinity_scratch_floats.argtypes = [V, ctypes.c_int]
    lib.affinity_scratch_floats.restype = ctypes.c_longlong
    lib.affinity_scratch_ints.argtypes = [V]
    lib.affinity_scratch_ints.restype = ctypes.c_longlong
    lib.schedule_affinity_wave_launch.argtypes = [V] + [ctypes.c_int] * 5 + [P] * 5
    lib.schedule_affinity_wave_launch.restype = ctypes.c_int
    # the lane kernels: the same arguments and the lane count S before the outputs
    lib.schedule_batch_lanes_launch.argtypes = [V, P, P, P, ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_longlong, ctypes.c_int, P, P, P]
    lib.schedule_batch_lanes_launch.restype = ctypes.c_int
    lib.schedule_wave_lanes_launch.argtypes = ([V] + [ctypes.c_int] * 3 + [P] * 3
                                               + [ctypes.c_int] * 3 + [P] * 5)
    lib.schedule_wave_lanes_launch.restype = ctypes.c_int
    lib.aggregate_commit_lanes_launch.argtypes = ([V, ctypes.c_int, P, P, P, P, P]
                                                  + [ctypes.c_int] * 3 + [P, P])
    lib.aggregate_commit_lanes_launch.restype = ctypes.c_int
    lib.schedule_group_serial_lanes_launch.argtypes = ([V, ctypes.c_int, P] + [ctypes.c_int] * 5
                                                       + [P] * 5)
    lib.schedule_group_serial_lanes_launch.restype = ctypes.c_int
    lib.schedule_affinity_wave_lanes_launch.argtypes = [V] + [ctypes.c_int] * 6 + [P] * 5
    lib.schedule_affinity_wave_lanes_launch.restype = ctypes.c_int
    lib.explain_scratch_floats.argtypes = [V]
    lib.explain_scratch_floats.restype = ctypes.c_longlong
    lib.explain_launch.argtypes = [V] + [ctypes.c_int] * 3 + [ctypes.c_longlong, P, P, P]
    lib.explain_launch.restype = ctypes.c_int
    lib.ext_args_size.argtypes = []
    lib.ext_args_size.restype = ctypes.c_int
    lib.extend_tables_launch.argtypes = [ctypes.POINTER(ExtArgs), ctypes.c_longlong, P]
    lib.extend_tables_launch.restype = ctypes.c_int
    if lib.ext_args_size() != ctypes.sizeof(ExtArgs):
        raise RuntimeError(f"ExtArgs layout mismatch: library {lib.ext_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(ExtArgs)}")
    if lib.tables_view_size() != ctypes.sizeof(TablesView):
        raise RuntimeError(f"TablesView layout mismatch: library {lib.tables_view_size()} "
                           f"bytes, ctypes {ctypes.sizeof(TablesView)}")
    return lib


def error_string(code: int) -> str:
    return library().error_string(int(code)).decode()
