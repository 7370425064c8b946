"""Build and load the CUDA kernels of csrc/ (nvcc → shared library → ctypes).

The library is compiled on first use for sm_90a with `--fmad=false` (no
contraction into fused multiply-adds: the kernels must round every operation
exactly as the plain PyTorch versions do) into `build/torch_kernels/` at the
root of the checkout, named by a digest of the sources and flags, so an edited
source never loads a stale binary. Each source compiles in its own nvcc
process, all started together, then one link makes the library. It has a
plain C interface and includes no PyTorch header, which keeps the build to
seconds. Nothing here runs at import.

The same sources build a second time with WIDE_FLAGS into the wide library
(`library(wide=True)`, its own digest and file), which takes the tables past
the default build's fixed slot, node-device and domain axes
(csrc/common.cuh OSIM_WIDE); ops/kernels.py loads it, on its first wide
table, for exactly those launches. A failed build raises in either case.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", f)
           for f in ("feasibility.cu", "schedule.cu", "wave.cu", "aggregate_commit.cu",
                     "group_serial.cu", "affinity_wave.cu", "extend.cu", "explain.cu",
                     "wave_sharded.cu", "affinity_sharded.cu", "wave_rounds.cu",
                     "affinity_rounds.cu", "batch_sharded.cu", "group_serial_sharded.cu",
                     "commit_sharded.cu")]
HEADERS = [os.path.join(_HERE, "csrc", f)
           for f in ("common.cuh", "cluster.cuh", "select.cuh", "affinity.cuh",
                     "wave_sharded.cuh", "affinity_sharded.cuh", "merge.cuh", "commit.cuh",
                     "wave_cluster.cuh")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]
WIDE_FLAGS = ["-DOSIM_WIDE=1"]

_lock = threading.Lock()
_libs: Dict[bool, ctypes.CDLL] = {}
# wall time and ptxas report of this process's build of each library, if it built
build_seconds: Optional[float] = None
ptxas_log: str = ""
wide_build_seconds: Optional[float] = None
wide_ptxas_log: str = ""


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


def flags(wide: bool = False) -> List[str]:
    return NVCC_FLAGS + (WIDE_FLAGS if wide else [])


def _digest(paths: List[str], wide: bool = False) -> str:
    h = hashlib.sha256(" ".join(flags(wide)).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(wide: bool = False) -> str:
    name = "libschedule_wide" if wide else "libschedule"
    return os.path.join(BUILD_DIR, f"{name}_{_digest(SOURCES + HEADERS, wide)}.so")


def _run_all(cmds: List[List[str]]) -> List[subprocess.CompletedProcess]:
    """Run the commands at once; wait for every one of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    done = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        done.append(subprocess.CompletedProcess(c, p.returncode, out, err))
    return done


def compile_library(wide: bool = False) -> str:
    """Compile csrc/ into the shared library, or with `wide` the wide one (if
    not already built); returns its path. Raises with nvcc's output when the
    build fails."""
    global build_seconds, ptxas_log, wide_build_seconds, wide_ptxas_log
    out = library_path(wide)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{'wide.' if wide else ''}{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in SOURCES]
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    try:
        compiled = _run_all([[nvcc, *flags(wide), "-c", "-o", o, s]
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
    seconds, log = time.perf_counter() - t0, "".join(p.stderr for p in compiled)
    if wide:
        wide_build_seconds, wide_ptxas_log = seconds, log
    else:
        build_seconds, ptxas_log = seconds, log
    return out


def library(wide: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (`wide`: the wide build), built on first
    use."""
    with _lock:
        if wide not in _libs:
            _libs[wide] = _load(compile_library(wide), wide)
    return _libs[wide]


def _load(path: str, wide: bool = False) -> ctypes.CDLL:
    from .kernels import CarryOut, ExtArgs, TablesView, WideTablesView

    lib = ctypes.CDLL(path)
    P = ctypes.c_void_p
    # the wide build's functions take the wide view (its TablesView)
    view = WideTablesView if wide else TablesView
    V = ctypes.POINTER(view)
    lib.tables_view_size.argtypes = []
    lib.tables_view_size.restype = ctypes.c_int
    lib.wide_build.argtypes = []
    lib.wide_build.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    I, L = ctypes.c_int, ctypes.c_longlong
    # K2 and K4 (thread-block clusters): scratch, shared memory, occupancy
    for name, args in (("schedule_scratch_floats", [V, I]), ("schedule_batch_smem", [V, I]),
                       ("group_serial_scratch_floats", [V, I]), ("group_serial_smem", [V, I]),
                       ("cluster_round_probe_smem", [I, I])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = L
    lib.schedule_batch_occupancy.argtypes = [I, I, I, L, P]
    lib.schedule_batch_occupancy.restype = I
    lib.group_serial_occupancy.argtypes = [I, I, L, P]
    lib.group_serial_occupancy.restype = I
    lib.cluster_round_probe_launch.argtypes = [I, I, I, I, P, P]
    lib.cluster_round_probe_launch.restype = I
    lib.cluster_kernels_init.argtypes = []
    lib.cluster_kernels_init.restype = I
    lib.schedule_batch_launch.argtypes = [V, P, P, P, I, P, P, P, I, L, P]
    lib.schedule_batch_launch.restype = ctypes.c_int
    # K3 and K5 (thread-block clusters): shared memory, scratch, occupancy
    for name, args in (("schedule_wave_smem", [I, I, I]), ("wave_scratch_floats", [I, I, I]),
                       ("affinity_wave_smem", [V, I, I]),
                       ("affinity_scratch_floats", [V, I, I])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = L
    lib.schedule_wave_occupancy.argtypes = [I, I, I, L, P]
    lib.schedule_wave_occupancy.restype = I
    lib.affinity_wave_occupancy.argtypes = [I, I, L, P]
    lib.affinity_wave_occupancy.restype = I
    lib.schedule_wave_launch.argtypes = [V] + [I] * 5 + [P] * 3 + [I, L, P]
    lib.schedule_wave_launch.restype = ctypes.c_int
    lib.schedule_group_serial_launch.argtypes = [V, I, P] + [I] * 4 + [P] * 4 + [I, L, P]
    lib.schedule_group_serial_launch.restype = ctypes.c_int
    lib.schedule_affinity_wave_launch.argtypes = [V] + [I] * 5 + [P] * 3 + [I, L, P]
    lib.schedule_affinity_wave_launch.restype = ctypes.c_int
    # the lane kernels: the same arguments and the lane count S before the outputs
    lib.schedule_batch_lanes_launch.argtypes = [V, P, P, P, I, L, L, I, P, P, P, I, L, P]
    lib.schedule_batch_lanes_launch.restype = ctypes.c_int
    lib.schedule_wave_lanes_launch.argtypes = ([V] + [I] * 3 + [P] * 3 + [I] * 3 + [P] * 3
                                               + [I, L, P])
    lib.schedule_wave_lanes_launch.restype = ctypes.c_int
    lib.schedule_group_serial_lanes_launch.argtypes = [V, I, P] + [I] * 5 + [P] * 4 + [I, L, P]
    lib.schedule_group_serial_lanes_launch.restype = ctypes.c_int
    lib.schedule_affinity_wave_lanes_launch.argtypes = [V] + [I] * 6 + [P] * 3 + [I, L, P]
    lib.schedule_affinity_wave_lanes_launch.restype = ctypes.c_int
    # K3c (one thread-block cluster a lane, out of place: the input carry's
    # view, then the new carry), K7 and K1 (one cluster over N), each with
    # its shape (C, smem)
    O = ctypes.POINTER(CarryOut)
    for name, args, res in (("aggregate_commit_smem", [], L),
                            ("aggregate_commit_init", [], I),
                            ("aggregate_commit_occupancy", [I, I, L, P], I),
                            ("aggregate_commit_launch", [V, O, I, P, P, P, P, I, I, P, I, L, P],
                             I),
                            ("aggregate_commit_lanes_launch",
                             [V, O, I, P, P, P, P, P, I, I, I, P, I, L, P], I),
                            ("explain_scratch_floats", [V], L),
                            ("explain_smem", [V, I], L),
                            ("explain_smem_max", [], L),
                            ("explain_init", [], I),
                            ("explain_occupancy", [I, I, L, P], I),
                            ("explain_launch", [V, I, I, I, L, P, P, I, L, P], I),
                            # K1
                            ("feasibility_smem", [V, I, I], L),
                            ("feasibility_smem_max", [], L),
                            ("feasibility_init", [], I),
                            ("feasibility_occupancy", [I, I, L, P], I),
                            ("feasibility_launch", [V, I, I, I, I, P, I, L, P], I)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    # K8 and K9, the sharded epoch paths: setup, front, table, tail
    lib.wave_sharded_scratch_floats.argtypes = [I]
    lib.wave_sharded_scratch_floats.restype = L
    lib.wave_sharded_scratch_ints.argtypes = [I]
    lib.wave_sharded_scratch_ints.restype = L
    lib.wave_sharded_pay_floats.argtypes = [I]
    lib.wave_sharded_pay_floats.restype = I
    # K8's table and tail on thread-block clusters, each with its shape (C,
    # smem); its setup and front are K10's (below)
    lib.wave_sharded_table_launch.argtypes = [V] + [I] * 5 + [P] * 5 + [I, L, P]
    lib.wave_sharded_tail_launch.argtypes = [V] + [I] * 5 + [P] * 6 + [I, L, P]
    for name, args, res in (("wave_sharded_smem", [I], L), ("wave_sharded_smem_max", [], L),
                            ("wave_sharded_init", [], I),
                            ("wave_sharded_occupancy", [I, I, L, P], I)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    lib.affinity_sharded_scratch_floats.argtypes = [V, I, I]
    lib.affinity_sharded_scratch_floats.restype = L
    lib.affinity_sharded_scratch_ints.argtypes = [V, I]
    lib.affinity_sharded_scratch_ints.restype = L
    lib.affinity_sharded_parts.argtypes = [V]
    lib.affinity_sharded_parts.restype = I
    lib.affinity_sharded_pay_floats.argtypes = [V, I]
    lib.affinity_sharded_pay_floats.restype = I
    # K9's stages on thread-block clusters, each with its shape (C, smem)
    lib.affinity_sharded_setup_launch.argtypes = [V] + [I] * 6 + [P] * 4 + [I, L, P]
    lib.affinity_sharded_front_launch.argtypes = [V] + [I] * 5 + [P] * 5 + [I, L, P]
    lib.affinity_sharded_table_launch.argtypes = [V] + [I] * 5 + [P] * 5 + [I, L, P]
    lib.affinity_sharded_tail_launch.argtypes = [V] + [I] * 5 + [P] * 7 + [I, L, P]
    for name, args, res in (("affinity_sharded_smem", [V, I], L),
                            ("affinity_sharded_tail_smem", [V, I], L),
                            ("affinity_sharded_smem_max", [], L),
                            ("affinity_sharded_cta_ints", [V, I], L),
                            ("affinity_sharded_init", [], I),
                            ("affinity_sharded_occupancy", [I, I, L, P], I)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    for stage in ("setup", "front", "table", "tail"):
        getattr(lib, f"affinity_sharded_{stage}_launch").restype = I
    for stage in ("table", "tail"):
        getattr(lib, f"wave_sharded_{stage}_launch").restype = I
    # K10, the wave's per-round path (thread-block clusters): setup, then
    # front, table, select, merge and finish, each with its shape (C, smem)
    lib.wave_rounds_merge_state_bytes.argtypes = []
    lib.wave_rounds_merge_state_bytes.restype = L
    lib.wave_rounds_smem.argtypes = [I]
    lib.wave_rounds_smem.restype = L
    lib.wave_rounds_occupancy.argtypes = [I, L, P]
    lib.wave_rounds_init.argtypes = []
    lib.wave_rounds_setup_launch.argtypes = [V] + [I] * 5 + [P] * 4 + [I, L, P]
    lib.wave_rounds_front_launch.argtypes = [V] + [I] * 4 + [P] * 4 + [I, L, P]
    lib.wave_rounds_table_launch.argtypes = [V] + [I] * 5 + [P] * 6 + [I, L, P]
    lib.wave_rounds_select_launch.argtypes = [I] * 6 + [P] * 5 + [I, L, P]
    lib.wave_rounds_merge_launch.argtypes = [V] + [I] * 9 + [P] * 7 + [I, L, P]
    lib.wave_rounds_finish_launch.argtypes = [I] * 4 + [P] * 7 + [I, L, P]
    for name in ("occupancy", "init", "setup_launch", "front_launch", "table_launch",
                 "select_launch", "merge_launch", "finish_launch"):
        getattr(lib, f"wave_rounds_{name}").restype = I
    # K11, the affinity wave's sharded tail: setup, then front, reduce,
    # table, select, merge, sandwich and finish; the cluster stages with
    # their shape (C, smem)
    for name, args, res in (("affinity_rounds_state_ints", [], I),
                            ("affinity_rounds_compact_ints", [], I),
                            ("affinity_rounds_smem", [V, I], L),
                            ("affinity_rounds_smem_max", [], L),
                            ("affinity_rounds_occupancy", [I, L, P], I),
                            ("affinity_rounds_init", [], I),
                            ("affinity_rounds_setup_launch", [V] + [I] * 6 + [P] * 4 + [I, L, P],
                             I),
                            ("affinity_rounds_front_launch", [V] + [I] * 6 + [P] * 5 + [I, L, P],
                             I),
                            ("affinity_rounds_reduce_launch", [V] + [I] * 6 + [P] * 6, I),
                            ("affinity_rounds_table_launch", [V] + [I] * 6 + [P] * 6 + [I, L, P],
                             I),
                            ("affinity_rounds_select_launch", [V] + [I] * 7 + [P] * 4 + [I, L, P],
                             I),
                            ("affinity_rounds_merge_launch", [V] + [I] * 6 + [P] * 6, I),
                            ("affinity_rounds_sandwich_launch",
                             [V] + [I] * 5 + [P] * 4 + [I, L, P], I),
                            ("affinity_rounds_finish_launch", [V] + [I] * 6 + [P] * 8 + [I, L, P],
                             I)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    # K12, the serial scan on a partitioned node mesh: front, sa, score,
    # commit, each one thread-block cluster with its shape (C, smem)
    for name, args, res in (("batch_sharded_scratch_floats", [V], L),
                            ("batch_sharded_part_floats", [V, I], I),
                            ("batch_sharded_smem", [V, I], L),
                            ("batch_sharded_smem_max", [], L),
                            ("batch_sharded_init", [], I),
                            ("batch_sharded_occupancy", [I, L, P], I),
                            ("batch_sharded_front_launch",
                             [V] + [I] * 6 + [P, I, I] + [P] * 3 + [I, L, P], I),
                            ("batch_sharded_sa_launch", [V, I, I, P, I, P, P, I, L, P], I),
                            ("batch_sharded_score_launch",
                             [V] + [I] * 3 + [P, I] + [P] * 4 + [L, I, L, P], I),
                            ("batch_sharded_commit_launch", [V] + [I] * 4 + [P] * 2 + [I, L, P],
                             I)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    # K13, the group-serial scan on a partitioned node mesh: setup, then per
    # pod front, sa, score, and the finish, each one thread-block cluster
    # with its shape (C, smem)
    for name, args, res in (("gs_sharded_scratch_floats", [V], L),
                            ("gs_sharded_scratch_ints", [V], L),
                            ("gs_sharded_part_floats", [V, I, I], I),
                            ("gs_sharded_marks_offset", [V, I], I),
                            ("gs_sharded_j_offset", [V], L),
                            ("gs_sharded_smem", [V, I], L),
                            ("gs_sharded_smem_max", [], L),
                            ("gs_sharded_init", [], I),
                            ("gs_sharded_occupancy", [I, L, P], I),
                            ("gs_sharded_setup_launch", [V, I, I, P, P, I, L, P], I),
                            ("gs_sharded_front_launch", [V] + [I] * 5 + [P] * 4 + [I, L, P], I),
                            ("gs_sharded_sa_launch", [V, I, I, P, I, I, P, P, P, I, L, P], I),
                            ("gs_sharded_score_launch",
                             [V] + [I] * 5 + [P, I] + [P] * 4 + [I, L, P], I),
                            ("gs_sharded_finish_launch", [V] + [I] * 4 + [P] * 3 + [I, L, P], I),
                            # K14, the aggregate commit on a partitioned node mesh
                            ("commit_sharded_smem", [], L),
                            ("commit_sharded_init", [], I),
                            ("commit_sharded_occupancy", [I, L, P], I),
                            ("commit_sharded_rows_launch", [V, O, I, P, P, I, I, P, I, L, P], I),
                            ("commit_sharded_domains_launch", [V, O, I, P, I, P, P, I, P], I)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    lib.ext_args_size.argtypes = []
    lib.ext_args_size.restype = ctypes.c_int
    lib.extend_tables_launch.argtypes = [ctypes.POINTER(ExtArgs), ctypes.c_longlong, P]
    lib.extend_tables_launch.restype = ctypes.c_int
    if lib.ext_args_size() != ctypes.sizeof(ExtArgs):
        raise RuntimeError(f"ExtArgs layout mismatch: library {lib.ext_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(ExtArgs)}")
    if lib.wide_build() != int(wide):
        raise RuntimeError(f"{path}: wide_build() is {lib.wide_build()}, expected {int(wide)}")
    if lib.tables_view_size() != ctypes.sizeof(view):
        raise RuntimeError(f"TablesView layout mismatch: library {lib.tables_view_size()} "
                           f"bytes, ctypes {ctypes.sizeof(view)}")
    return lib


def error_string(code: int) -> str:
    return library().error_string(int(code)).decode()
