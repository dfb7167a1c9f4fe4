"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``*.cu`` source under ``controlnet_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into an object file (one ``nvcc`` per source, all
started together), then linked into ``build/kernels/libcontrolnet_kernels.so``
at the repository root.  The sources (and the ``*.cuh`` headers they share)
have a plain C interface and include no PyTorch headers.  The library is
rebuilt when any source or header is newer than it.

Ranks of a data-parallel run share ``build/kernels/``: the staleness check,
the build and the load run under an inter-process lock
(``build/kernels/.lock``, ``fcntl.flock``), so the first rank builds and the
others, which check again once they hold the lock, load what it built.  Each
object file and the library are written under a per-process name and moved
into place with ``os.replace``.

Nothing here runs at import time: this module is imported on hosts with no
``nvcc`` (the CPU tests), where only the kernels' plain versions run.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libcontrolnet_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
ptxas_report = ""  # ptxas's register / spill report of the last verbose build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources() + headers())


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with the output of any that
    fails, else return their outputs."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs, failures = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return outputs


@contextlib.contextmanager
def _build_lock():
    """Hold ``build/kernels/.lock`` against every other process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _compile_and_link(verbose: bool = False) -> Path:
    """Compile every source and link ``LIB_PATH`` (the caller holds the
    lock).  ``verbose`` prints ptxas's register / shared-memory / spill
    report."""
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    tag = f".{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.o" for src in sources()]
    tmp_objs = [obj.with_suffix(tag) for obj in objs]
    outputs = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources(), tmp_objs)])
    if verbose:
        global ptxas_report
        ptxas_report = "\n".join(outputs)
        print(ptxas_report, flush=True)
    for tmp, obj in zip(tmp_objs, objs):
        os.replace(tmp, obj)
    tmp = LIB_PATH.with_suffix(tag)
    # -ldl: the bf16 kernels a, b, c and d look up cuTensorMapEncodeTiled in libcuda
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-ldl", "-o", str(tmp)]])
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels into ``LIB_PATH`` (always rebuilds),
    under the build lock."""
    with _build_lock():
        return _compile_and_link(verbose)


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale.  The
    staleness check, the build and the load hold the build lock; a process
    that waited on another's build checks again and finds it done."""
    global _lib
    with _lock:
        if _lib is None:
            with _build_lock():
                if _stale():
                    _compile_and_link()
                lib = ctypes.CDLL(str(LIB_PATH))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            # (q, k, v, o, lse, o32), (batch, heads, dh, lq, lk), batch
            # strides, (dtype, kv_tile, threads, q_vec, k_vec), stream, phase
            # counters
            lib.controlnet_attention_fwd_t.argtypes = (
                [ptr] * 6 + [i32] * 5 + [i64] * 3 + [i32] * 5 + [ptr] * 2)
            # (q, k, v, o, dout, lse, delta, dq, dk, dv, part), (batch, heads,
            # dh, lq, lk), batch strides, (dtype, kv_tile, q_tile, threads_q,
            # threads_k, split, q_vec, k_vec), stream, phase counters
            lib.controlnet_attention_bwd_t.argtypes = (
                [ptr] * 11 + [i32] * 5 + [i64] * 3 + [i32] * 8 + [ptr] * 2)
            # float32: (x, w, bias, out, partial sums), (cin, cout, batch, h,
            # w), (channel, batch) strides of x, (pixel tile, channel tile,
            # threads, splits, weights as held), stream
            lib.controlnet_conv3x3_tl.argtypes = (
                [ptr] * 5 + [i32] * 5 + [i64] * 2 + [i32] * 5 + [ptr])
            # bfloat16 on wgmma: the same tensors and shape, then
            # (warpgroups, channel tile, stages, splits, blocks), stream,
            # phase counters
            lib.controlnet_conv3x3_tl_bf16.argtypes = (
                [ptr] * 5 + [i32] * 5 + [i64] * 2 + [i32] * 5 + [ptr] * 2)
            # bfloat16 on mma.sync (wide images): (x, w, bias, out), (cin,
            # cout, batch, h, w), strides of x, output channel groups, stream
            lib.controlnet_conv3x3_tl_bf16_mma.argtypes = (
                [ptr] * 4 + [i32] * 5 + [i64] * 2 + [i32] + [ptr])
            # (x, in_w, in_b, out_w, out_b, y), (batch, l, c, d, heads), (batch,
            # row, channel) strides of x and of y, (dtype, rows per block,
            # query tiles, head groups, shared bytes), stream, phase counters
            lib.controlnet_attention_proj.argtypes = (
                [ptr] * 6 + [i32] * 5 + [i64] * 6 + [i32] * 5 + [ptr] * 2)
            # (l, c, d, heads, dtype, rows, q_tiles, head_groups, shared
            # bytes), out: clusters the card holds at once
            lib.controlnet_attention_proj_clusters.argtypes = (
                [i32] * 9 + [ctypes.POINTER(ctypes.c_int)])
            # (x, in_w, in_b, out_w, out_b, y, qkv scratch, head-output
            # scratch), (batch, l, c, d, heads), strides of x and of y,
            # (elems, tiles, groups, heads a projection tile, output columns
            # a tile, weight stages, K|V stages, warpgroups a block, blocks
            # an SM, x route, x vec, shared bytes), stream, phase counters
            lib.controlnet_attention_proj_bf16.argtypes = (
                [ptr] * 8 + [i32] * 5 + [i64] * 6 + [i32] * 12 + [ptr] * 2)
            # (l, c, d, heads, elems, tiles, groups, heads a projection tile,
            # output columns a tile, weight stages, K|V stages, warpgroups a
            # block, blocks an SM, shared bytes), out: clusters the card holds
            # at once
            lib.controlnet_attention_proj_bf16_clusters.argtypes = (
                [i32] * 14 + [ctypes.POINTER(ctypes.c_int)])
            for fn in (lib.controlnet_attention_fwd_t, lib.controlnet_attention_bwd_t,
                       lib.controlnet_conv3x3_tl, lib.controlnet_conv3x3_tl_bf16,
                       lib.controlnet_conv3x3_tl_bf16_mma,
                       lib.controlnet_attention_proj,
                       lib.controlnet_attention_proj_clusters,
                       lib.controlnet_attention_proj_bf16,
                       lib.controlnet_attention_proj_bf16_clusters):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
