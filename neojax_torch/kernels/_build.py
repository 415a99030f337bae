"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, bound with ``ctypes``.

Sources are ``neojax_torch/csrc/*.cu`` and ``*.cuh`` only. The library is
built at first use into ``neojax_torch/_build/`` (git-ignored), named by a
hash of the sources and flags, so an edit to any source rebuilds it. Every
``.cu`` is compiled by its own nvcc process, all started together, and the
objects are then linked into one library. Each C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.

Nothing here runs at import time: the CPU test suite imports every module
of the package on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load", "check", "stream_of", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures of the entry points (argtypes, in order). Pointers and the
# stream are c_void_p: a bare Python int would be passed as a 32-bit int.
_SIGNATURES = {
    # storage, fdl, filt_re, filt_im, scales, live, acc, part, P, C, K, Cf, pc,
    # k_tile, nk, S, per, vec, stream
    "neo_fdl_mac": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # mat_bf16, inverse, in, i_inner, i_s_outer, i_s_inner, out, o_inner,
    # o_s_outer, o_s_inner, tw, rows, B, n_out, stream
    "neo_transform": [_I, _I, _P, _I, _L, _L, _P, _I, _L, _L, _P, _I, _I, _I, _P],
    # storage, frame, fdl, rim, scales, dcfix, tw, y, c_idx, c_flags, spec, x,
    # scl, mpart, acc, tab, counts, P, C, B, Cf, pos, L, pc, n_codes, S, per,
    # vec, stream
    "neo_fused_block_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    # storage, s, x, scl, rows, C, B, stream
    "neo_fs_quantize": [_I, _P, _P, _P, _I, _I, _I, _P],
    # storage, x, scl, fdl, scales, P, C, B, wc, pos_first, stream
    "neo_fs_writeback": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # c_idx, c_flags, tab, P, L, nchunks, B, n_codes, stream
    "neo_fs_widths": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # storage, ring, scales, xnew, snew, rim, seed, dcfix, wtab, ttab, tsteps,
    # items, acc, P, C, B, Cf, wc, pos_first, pc, nchunks, nt, ns, n_items,
    # nc, vec_h, vec_f, smem, stream
    "neo_fs_stream_mac": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # storage, ring, scales, fre, fim, f_row, f_c, wrow, part, P, C, K, pc, S, per, vec, stream
    "neo_fs_step_mac": [_I, _P, _P, _P, _P, _L, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # mat_bf16, part, dcfix, acc, S, C, K, stream
    "neo_fs_step_reduce": [_I, _P, _P, _P, _I, _I, _I, _P],
    # storage, planes, scales, filt_re, filt_im, acc_re, acc_im, P2, C, K, L, G, stream
    "neo_nested_mac": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # storage, fdl, fr, out, part, P, C, K, pc, S, per, vec, stream
    "neo_probe_ring_read": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # mode, spec, out, C, B, nb, wc, i0, stream
    "neo_probe_fold": [_I, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
_info: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of neojax_torch are built from source at first use"
    )


def _compile(out: Path) -> str:
    """nvcc every .cu into ``out``: one compile process per source, started
    together, then one link. Returns nvcc's log (ptxas -v included)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in cus]
        jobs = []
        for src, obj in zip(cus, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for cmd, proc in jobs:  # wait for every compile, failed or not
            so, se = proc.communicate()
            log.append(so + se)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{se}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    return "".join(log) + res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (or when a source changed)."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_DIR / f"libneojax_torch_{_digest()}.so"
    t0 = time.perf_counter()
    built = not so.exists()
    if built:
        log = _compile(so)
        (BUILD_DIR / f"{so.stem}.log").write_text(log)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.neo_error_string.argtypes = [_I]
    lib.neo_error_string.restype = ctypes.c_char_p
    _info.update(path=str(so), built=built, seconds=time.perf_counter() - t0)
    _lib = lib
    return lib


def build_info() -> dict:
    """Where the loaded library lives, whether this process built it, and
    how long loading (and building) took."""
    return dict(_info)


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = load().neo_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")
