"""The fused per-block pipeline, B2 (one block) and B3 (a whole UPOLS
stream), as stage kernels in ``csrc/fused_step.cu`` and ``csrc/transform.cu``.

Replaces ``neojax/kernels/fused_step.py`` · ``fused_block_step`` (Pallas
body ``_mk_kernel``) and ``fused_stream`` (body ``_mk_stream_kernel``). The
function is theirs; per block, for each channel:

    frame rounded to the matrix dtype -> packed forward DFT -> quantize
    (per-(block, channel) peak scale, ``x / scale * int_max``, rint, clamp)
    or cast -> ring row ``pos`` written with its scale -> rotated-filter MAC
    over P (the new row read back in its storage dtype with its new scale;
    B3 may seed the sum from ``acc_add``) -> lane 0 := ``dcfix`` ->
    accumulator rounded to the matrix dtype -> packed inverse DFT (all N
    samples for B2, the UPOLS tail half for B3)

Layout contract (as the JAX package's): packed-512 spectra, B = N/2 lanes,
re-plane lane 0 = DC.re, im-plane lane 0 = Nyquist.re; the filter arrives
lane-packed re|im ``filt_rim [2P, C', 2B]`` (tiled-reversed, C' in {1, C});
storage-matched matrix/filter dtype — bf16 for the bf16/int8 storages, f32
for split/int16 — with the frame (forward) and the accumulator (inverse)
rounded to that dtype first.

Design (H100). The block-by-block loop of the TPU kernel re-reads the ring
every block (252 MB split at P = 960, C = 64, B = 512) and, written per
channel, streams the DFT matrices once per channel and block. Neither the
forward transforms nor the quantization depend on the ring, and block i's
MAC ``sum_a filt[a] X[i - a]`` (``filt[a] = filt_rim[P - 1 - a]`` for the
tiled filter) is a causal convolution along time. So B3 walks its nb blocks in windows of
:data:`WINDOW` blocks, each window five stage launches on one stream:

1. :func:`window_forward` — the window's frames through the packed real
   DFT, one shared-memory FFT a row (f32; frames rounded to the matrix
   dtype first)
2. :func:`quantize_rows` — spectra -> staged rows ``X_new [W, 2, C, B]`` in
   the storage dtype, scales ``[W, C]``
3. :func:`stream_mac` — the time-batched MAC: history rows inside the
   window from ``X_new``, older ones from the ring, each dequantized with
   its own scale; lane 0 := ``dcfix``; rounded to the matrix dtype. For
   each lane a complex product of the Toeplitz matrix of the filter rows
   [blocks, history rows] by the history [history rows, channels], in f32
   FFMA on tiles staged in shared memory by ``cp.async``
   (:func:`stream_mac_geometry`; a shared filter over more than 4 channels
   without a table takes its own kernel, :func:`stream_mac_route`,
   :func:`stream_mac_dense_geometry`)
4. :func:`ring_writeback` — ``X_new`` into ring slots ``(pos0 + i) % P``
   after the MAC (the last write wins when W > P)
5. :func:`window_inverse` — the accumulators through the inverse FFT,
   straight into the output

B2 is one block: :func:`window_forward`, :func:`quantize_rows`,
:func:`ring_writeback` into row ``pos`` (in place, before the MAC),
:func:`step_mac` (the ring read on a (lane tile, channel, P split) grid with
16-byte loads) and :func:`step_reduce` (the splits added in a fixed order,
lane 0 := ``dcfix``, rounded), then :func:`window_inverse` against ``ab``.
On the card one C call (``neo_fused_block_step``) launches these kernels:
a block's device time (~0.1 ms at the headline shape) is less than the
host's cost of a call per stage. The C call counts each stage's launch as
it makes it, and the wrapper adds those counts to the stages' counters.
The MAC sums in another order than the block-by-block loop; the
per-storage tolerances of ``tests/test_fused_step.py`` hold.

Sparse filters. B2 takes the chunk schedule (``sched=``) of
``kernels.sparse_mac.build_chunk_schedule`` — the FULL ``[P, L]`` int32
tables ``(c_idx, flags)`` from the params, on the ring's device — and
honours its row ``pos``: slot p contributes only if its chunk of
:func:`fused_chunk_rows` rows is flagged in that row, and only on lanes
``k < B >> code``. :func:`sched_widths` turns the tables into a ``[P, P /
pc]`` table of live widths; :func:`step_mac` skips the chunks that are dead
and masks the rest, in the dense kernel's order.

B3 takes the tap-tile table (``tiles=``, the convolver's
``params["tap_tiles"]``, :func:`tap_tile_table`): uint8 ``[P, B / 8]``,
live where the mask keeps some bin of a lane tile of 8 lanes at a tap
(partition), the same at every ring position. With it :func:`stream_mac`
runs only the (history step, lane tile) pairs that meet a live tap, over a
list of work items balanced by their cost (:func:`stream_mac_plan`), and
:func:`fused_stream` walks windows :data:`TILES_WINDOWS` times longer.
Both sparse forms skip only bins the mask drops, exact zeros of the
masked filter, so the sparse kernels equal the dense ones on it. :func:`fused_stream_reference` takes the
schedule: the block-by-block oracle the table route is held against.

The transform kernels compute the DFT itself, so B2, B3 and the two
transform stages take only the packed DFT matrices of
``fft.matmul_backend`` as their ``cs``/``ab``/``abt`` operands
(:func:`_check_dft`; a departure from the TPU kernels, which multiply by
whatever matrix they are given). With bf16 matrices the FFT's f32
twiddles are more exact than the bf16-rounded matrix.

Every stage function runs its plain PyTorch version (float64 products,
operands rounded where the kernel rounds them; named ``*_reference``) for
CPU tensors and launches its kernel, or raises, for CUDA tensors; each
counts its launches in ``.launches``. So the CPU route of
:func:`fused_stream` / :func:`fused_block_step` runs the staged
decomposition itself. The block-by-block loops
(:func:`fused_block_step_reference`, :func:`fused_stream_reference`) stay
as the oracle it is held against. Both routes update the ring (and
scales) in place.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import weakref

import numpy as np
import torch

from neojax_torch import trace
from neojax_torch.kernels import _build
from neojax_torch.kernels.fdl_mac import STORAGE_CODES, step_geometry
from neojax_torch.kernels.sparse_mac import lane_widths

__all__ = [
    "MATRIX_DTYPES",
    "MAX_BLOCK",
    "WINDOW",
    "TILES_WINDOWS",
    "fused_chunk_rows",
    "fused_block_step",
    "fused_block_step_reference",
    "fused_stream",
    "fused_stream_reference",
    "stage_wrappers",
    "window_forward",
    "window_forward_reference",
    "quantize_rows",
    "quantize_rows_reference",
    "stream_mac",
    "stream_mac_geometry",
    "stream_mac_plan",
    "stream_mac_reference",
    "tap_tile_table",
    "ring_writeback",
    "ring_writeback_reference",
    "window_inverse",
    "window_inverse_reference",
    "sched_widths",
    "sched_widths_reference",
    "step_mac",
    "step_mac_reference",
    "step_reduce",
    "step_reduce_reference",
]

# storage dtype -> transform-matrix / fused-filter dtype
MATRIX_DTYPES = {
    torch.float32: torch.float32,
    torch.bfloat16: torch.bfloat16,
    torch.int16: torch.float32,
    torch.int8: torch.bfloat16,
}
_INT_MAX = {torch.int8: 127.0, torch.int16: 32767.0}
MAX_BLOCK = 1024  # the largest block the pipeline takes (the TPU kernels' bound)
WINDOW = 64  # blocks a window of B3's staged pipeline (staging ~17 MB at the headline shape)
# B3 with a tap-tile table walks windows this many times longer: two block
# tiles of the tiles kernel a launch, so the list schedule also splits the
# lane tiles live at every tap by blocks (with one block tile their items
# set the launch's time, 0.20 ms of a mean slot load near 0.13 ms at the
# masked benchmark cell on the H100), and half the launches a stream
TILES_WINDOWS = 2

# Bytes per partition chunk of the chunk schedule, as neojax sizes its TPU
# DMA chunks (``neojax.kernels.fused_step._CHUNK_TARGET``), so both packages
# build the same tables. A module constant, so a test can shrink it in both.
_CHUNK_TARGET = 1024 * 1024


def fused_chunk_rows(dtype: torch.dtype, p: int, c: int, b: int) -> int:
    """Partition rows per schedule chunk (``neojax``'s ``fused_chunk_rows``):
    about ``_CHUNK_TARGET`` bytes of ring, an exact divisor of P,
    preferring multiples of 8."""
    bytes_per_row = 2 * c * b * dtype.itemsize
    cap = max(1, min(p, _CHUNK_TARGET // max(1, bytes_per_row)))
    if p % 8 == 0:
        cap = max(cap, 8)
        for d in range(cap - cap % 8, 7, -8):
            if p % d == 0:
                return d
    for d in range(cap, 0, -1):
        if p % d == 0:
            return d
    return 1


# ---------------------------------------------------------------- checks


def _check_ring(fdl, filt_rim, scales, c: int):
    if fdl.ndim != 4 or fdl.shape[0] != 2 or fdl.shape[2] != c:
        raise ValueError(f"fdl must be [2, P, {c}, B], got {tuple(fdl.shape)}")
    if fdl.dtype not in STORAGE_CODES:
        raise TypeError(f"unsupported fdl dtype {fdl.dtype}")
    _, p, _, b = fdl.shape
    if b % 2 or b > MAX_BLOCK:
        raise ValueError(f"block size must be even and <= {MAX_BLOCK}, got {b}")
    mdt = MATRIX_DTYPES[fdl.dtype]
    if filt_rim.dtype != mdt:
        raise TypeError(f"filt_rim must be {mdt} for {fdl.dtype} storage, got {filt_rim.dtype}")
    if (filt_rim.ndim != 3 or filt_rim.shape[0] != 2 * p or filt_rim.shape[1] not in (1, c)
            or filt_rim.shape[2] != 2 * b):
        raise ValueError(f"filt_rim must be [{2 * p}, 1|{c}, {2 * b}], got {tuple(filt_rim.shape)}")
    quant = fdl.dtype in _INT_MAX
    if quant != (scales is not None):
        raise ValueError("scales [P, C] are required for int storage and only for it")
    if quant and (scales.dtype != torch.float32 or tuple(scales.shape) != (p, c)):
        raise ValueError(f"scales must be float32 [{p}, {c}], got {scales.dtype} {tuple(scales.shape)}")
    return p, b, mdt


def _check_common(tensors, name):
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"all {name} operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cpu"


def _check_sched(sched, fdl):
    """Validate ``sched = (c_idx, flags)`` against the ring; returns its
    rows a chunk (None without a schedule)."""
    _, p, c, b = fdl.shape
    widths = lane_widths(b)
    # the kernels compute a code's width as B >> code
    assert all(wd == b >> code for code, wd in enumerate(widths))
    if sched is None:
        return None
    c_idx, flags = sched
    for name, t in (("c_idx", c_idx), ("flags", flags)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.ndim != 2 or t.shape[0] != p:
            raise ValueError(f"sched {name} must be an int32 [{p}, L] tensor")
        if t.device != fdl.device or not t.is_contiguous():
            raise ValueError(f"sched {name} must be contiguous and on the ring's device")
    if c_idx.shape != flags.shape:
        raise ValueError("sched c_idx and flags shapes differ")
    if c_idx.device.type == "cpu" and int((c_idx >> 16).max()) >= len(widths):
        raise ValueError(f"sched holds a width code outside lane_widths({b}) = {widths}")
    return fused_chunk_rows(fdl.dtype, p, c, b)


def _check_tiles(tiles, p: int, b: int) -> None:
    """Validate a tap-tile table (:func:`tap_tile_table`) against a ring of
    P partitions and B lanes."""
    nt = -(-b // _MAC_LANES)
    if tiles is not None and (not isinstance(tiles, torch.Tensor) or tiles.dtype != torch.uint8
                              or tuple(tiles.shape) != (p, nt)):
        raise ValueError(f"tiles must be a uint8 [{p}, {nt}] tensor")


def _quant_scale(scales, dtype):
    """Dequantization factors ``scale * (1 / int_max)`` in f32 (the kernels'
    order), as float64."""
    return (scales * (1.0 / _INT_MAX[dtype])).double()


# ------------------------------------------------- 1 + 5. the transforms


def _mat_geometry(mat):
    """(depth N, columns) of a transform matrix: [K, n] as it is, or B2's
    forward planes [2, N, B] side by side."""
    if mat.ndim == 2:
        return mat.shape[0], mat.shape[1]
    _, k, b = mat.shape
    return k, 2 * b


def _mat2d(mat):
    return mat if mat.ndim == 2 else torch.cat([mat[0], mat[1]], dim=-1)


def fft_radices(b: int) -> tuple[int, list[int]]:
    """(odd factor m, radices) of the transform kernels' B-point complex FFT
    (``csrc/transform.cu`` :: ``cfft``): a direct m-point stage when m > 1,
    then radix-8 stages, radix 4 where 4 or 16 points remain, radix 2 where
    2 do."""
    m = b
    while m % 2 == 0:
        m //= 2
    rest, radices = b // m, []
    while rest > 1:
        r = 2 if rest == 2 else 4 if rest in (4, 16) else 8
        radices.append(r)
        rest //= r
    return m, radices


@functools.lru_cache(maxsize=16)
def _twiddles(n: int, device: str) -> torch.Tensor:
    """The transform kernels' twiddles as float32 [T, 2] (re, im) on
    ``device``, computed in float64 on the host: W_N^q = exp(-2 pi i q / N)
    for q < N (the real pass and the odd stage), then each radix-R stage's
    table W_{Ns R}^{k r} at [(r - 1) Ns + k], k < Ns, 1 <= r < R, Ns the
    product of the earlier stages' radices (and the odd factor)."""
    b = n // 2
    m, radices = fft_radices(b)
    q = [np.arange(n) / n]
    ns = m
    for r in radices:
        k = np.arange(ns)
        q.append((np.arange(1, r)[:, None] * k[None, :]).ravel() / (ns * r))
        ns *= r
    ang = -2.0 * np.pi * np.concatenate(q)
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)).to(device)


def twiddles(n: int, device) -> torch.Tensor:
    """:func:`_twiddles` for a device (cached; callers must not write to it)."""
    return _twiddles(n, str(torch.device(device)))


# operands found equal to the packed DFT matrix: id -> (weakref, version)
_DFT_EQUAL: dict[int, tuple] = {}


def _check_dft(mat, n: int, inverse: bool) -> None:
    """Raise ``ValueError`` unless ``mat`` is the packed DFT matrix of N = n
    in its dtype, in one of the forms the fused kernels take (forward: B3's
    ``cs [N, 2B]`` or B2's ``[2, N, B]``; inverse: B3's tail half ``abt
    [2B, B]``, B2's ``ab [2, B, N]`` or ``ab`` as ``[2B, N]``): the cached
    tensor of ``matmul_backend.packed_mats`` / ``packed_stream_mats``, a
    view of its memory, or a tensor equal to it. The kernels compute the
    DFT, not a product with an arbitrary matrix. An equal tensor is
    compared once: it is remembered by identity and version, so a caller
    that passes the same operand every block pays no device sync."""
    from neojax_torch.fft.matmul_backend import packed_mats, packed_stream_mats

    b = n // 2
    if inverse:
        forms = {(2 * b, b): lambda: packed_stream_mats(n, mat.dtype, mat.device)[1],
                 (2 * b, n): lambda: packed_mats(n, mat.dtype, mat.device)[1].reshape(2 * b, n),
                 (2, b, n): lambda: packed_mats(n, mat.dtype, mat.device)[1]}
    else:
        forms = {(n, 2 * b): lambda: packed_stream_mats(n, mat.dtype, mat.device)[0],
                 (2, n, b): lambda: packed_mats(n, mat.dtype, mat.device)[0]}
    make = forms.get(tuple(mat.shape))
    if make is None or mat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"not a packed {'inverse' if inverse else 'forward'} DFT matrix of N = {n}: "
                         f"{mat.dtype} {tuple(mat.shape)}")
    ref = make()
    if mat is ref or (mat.data_ptr() == ref.data_ptr() and mat.stride() == ref.stride()):
        return
    seen = _DFT_EQUAL.get(id(mat))
    if seen is not None and seen[0]() is mat and seen[1] == mat._version:
        return
    if not torch.equal(mat, ref):
        raise ValueError(f"the {'inverse' if inverse else 'forward'} matrix is not the packed DFT of "
                         f"N = {n} (matmul_backend.packed_mats / packed_stream_mats): the kernels "
                         "compute the DFT, not a product with an arbitrary matrix")
    if len(_DFT_EQUAL) > 256:
        _DFT_EQUAL.clear()
    _DFT_EQUAL[id(mat)] = (weakref.ref(mat), mat._version)


def _transform(inverse: bool, bf16: bool, a, a_map, out, o_map, rows: int, b: int, n_out: int):
    """Launch the transform kernel over ``rows`` rows of block ``b`` with the
    row maps ``(inner, s_outer, s_inner)`` (elements)."""
    code = _build.load().neo_transform(
        int(bf16), int(inverse), a.data_ptr(), *a_map, out.data_ptr(), *o_map,
        twiddles(2 * b, out.device).data_ptr(), rows, b, n_out, _build.stream_of(out),
    )
    _build.check(code, "transform")


def window_forward_reference(x, mat, i0: int, wc: int, out=None):
    """Plain :func:`window_forward` (float64 products with ``mat``)."""
    depth, _ = _mat_geometry(mat)
    b = depth // 2
    frames = x[:, i0 * b : (i0 + wc + 1) * b].unfold(1, depth, b)  # [C, wc, N]
    spec = (frames.to(mat.dtype).double() @ _mat2d(mat).double()).float().transpose(0, 1)
    if out is None:
        return spec.contiguous()
    out.copy_(spec)
    return out


def window_forward(x, mat, i0: int, wc: int, out=None):
    """Forward packed real DFTs of ``wc`` blocks from block ``i0``: the
    frames' product with the packed forward matrix.

    x   : [C, L] f32, frames of N = 2B samples at hop B (B3's ``sigpad``, or
          B2's ``frame`` as one block)
    mat : the packed forward DFT matrix, [N, 2B] (B3's ``cs``) or [2, N, B]
          (B2's), f32 or bf16; the frames are rounded to its dtype. The
          kernel computes the DFT (one shared-memory FFT a row, f32), so on
          the card ``mat`` must be that matrix (``_check_dft``)
    out : optional [wc, C, 2B] f32 destination
    returns spectra [wc, C, 2B] f32 (re | im lanes)
    """
    c, length = x.shape
    depth, cols = _mat_geometry(mat)
    b = depth // 2
    if x.dtype != torch.float32 or mat.dtype not in (torch.float32, torch.bfloat16) or cols != 2 * b:
        raise ValueError("window_forward takes f32 frames and an f32/bf16 [N, 2B] or [2, N, B] matrix")
    if i0 < 0 or wc < 1 or (i0 + wc + 1) * b > length:
        raise ValueError(f"blocks [{i0}, {i0 + wc}) need {(i0 + wc + 1) * b} samples, have {length}")
    if _check_common([x, mat, out], "window_forward"):
        return window_forward_reference(x, mat, i0, wc, out)
    if b % 2 or b > MAX_BLOCK:
        raise ValueError(f"the transform kernel takes an even block <= {MAX_BLOCK}, got {b}")
    _check_dft(mat, depth, inverse=False)
    if out is None:
        out = torch.empty((wc, c, cols), dtype=torch.float32, device=x.device)
    # row (i, c) starts at sample c * L + (i0 + i) * B of x, at i * C + c of out
    _transform(False, mat.dtype == torch.bfloat16, x[:, i0 * b :], (c, b, length), out, (1, cols, 0),
               wc * c, b, depth)
    window_forward.launches += 1
    return out


window_forward.launches = 0


def window_inverse_reference(acc, inv, out, i0: int):
    """Plain :func:`window_inverse` (float64 products with ``inv``)."""
    wc, c, _ = acc.shape
    n_out = inv.shape[1]
    y = (acc.to(inv.dtype).double() @ inv.double()).float()  # [wc, C, n_out]
    out[:, i0 * n_out : (i0 + wc) * n_out] = y.transpose(0, 1).reshape(c, wc * n_out)
    return out


def window_inverse(acc, inv, out, i0: int):
    """Inverse packed real DFTs of a window's accumulators: their product
    with the packed inverse matrix.

    acc : [wc, C, 2B] f32, rounded to the matrix dtype on the way in
    inv : the packed inverse DFT matrix [2B, n_out] (B3's tail-half ``abt``
          [2B, B]; B2's ``ab`` [2, B, N] reshaped to [2B, N]), f32 or bf16.
          The kernel computes the inverse DFT (one shared-memory FFT a row,
          f32), so on the card ``inv`` must be that matrix (``_check_dft``)
    out : [C, nbo * n_out] f32; block i goes to columns (i0 + i) * n_out on
    returns out
    """
    wc, c, depth = acc.shape
    n_out = inv.shape[1] if inv.ndim == 2 else 0
    if (acc.dtype != torch.float32 or inv.ndim != 2 or inv.shape[0] != depth
            or inv.dtype not in (torch.float32, torch.bfloat16) or out.dtype != torch.float32
            or out.ndim != 2 or out.shape[0] != c or out.shape[1] < (i0 + wc) * n_out or i0 < 0):
        raise ValueError("window_inverse takes acc [wc, C, 2B] f32, inv [2B, n] and out [C, >= (i0+wc) n] f32")
    if _check_common([acc, inv, out], "window_inverse"):
        return window_inverse_reference(acc, inv, out, i0)
    b = depth // 2
    if b % 2 or b > MAX_BLOCK:
        raise ValueError(f"the transform kernel takes an even block <= {MAX_BLOCK}, got {b}")
    _check_dft(inv, depth, inverse=True)
    # row (i, c) of acc lands at column (i0 + i) * n_out of out's row c
    _transform(True, inv.dtype == torch.bfloat16, acc, (1, depth, 0), out[:, i0 * n_out :],
               (c, n_out, out.shape[1]), wc * c, b, n_out)
    window_inverse.launches += 1
    return out


window_inverse.launches = 0


# ------------------------------------------------------- 2. quantize


def quantize_rows_reference(s, dtype, x=None, scl=None):
    """Plain :func:`quantize_rows`."""
    wc, c, w = s.shape
    b = w // 2
    spec = s.reshape(wc, c, 2, b).transpose(1, 2)  # [wc, 2, C, B]
    if dtype in _INT_MAX:
        m = _INT_MAX[dtype]
        peak = torch.amax(torch.abs(s), dim=-1)  # [wc, C]
        scale = torch.where(peak > 0, peak, torch.ones_like(peak))
        q = torch.clamp(torch.round(spec / scale[:, None, :, None] * m), -m, m).to(dtype)
    else:
        scale, q = None, spec.to(dtype)
    x = q.contiguous() if x is None else x.copy_(q)
    if scale is not None:
        scl = scale if scl is None else scl.copy_(scale)
    return x, scl


def quantize_rows(s, dtype, x=None, scl=None):
    """Spectra -> ring rows: quantize (per-(block, channel) peak scale,
    ``x / scale * int_max``, rint, clamp) for int storages, else cast.

    s   : [wc, C, 2B] f32
    x   : optional [wc, 2, C, B] destination in the storage ``dtype``
    scl : optional [wc, C] f32 destination (int storages)
    returns (x, scl), scl None for split and bf16
    """
    wc, c, w = s.shape
    b = w // 2
    quant = dtype in _INT_MAX
    if s.dtype != torch.float32 or w % 2 or dtype not in STORAGE_CODES:
        raise ValueError("quantize_rows takes f32 spectra [wc, C, 2B] and a storage dtype")
    if _check_common([s, x, scl], "quantize_rows"):
        return quantize_rows_reference(s, dtype, x, scl)
    if x is None:
        x = torch.empty((wc, 2, c, b), dtype=dtype, device=s.device)
    if quant and scl is None:
        scl = torch.empty((wc, c), dtype=torch.float32, device=s.device)
    if x.dtype != dtype or tuple(x.shape) != (wc, 2, c, b):
        raise ValueError(f"x must be {dtype} [{wc}, 2, {c}, {b}]")
    code = _build.load().neo_fs_quantize(
        STORAGE_CODES[dtype], s.data_ptr(), x.data_ptr(), scl.data_ptr() if quant else 0,
        wc * c, c, b, _build.stream_of(s),
    )
    _build.check(code, "quantize_rows")
    quantize_rows.launches += 1
    return x, scl if quant else None


quantize_rows.launches = 0


# ------------------------------------------------------ 4. write-back


def _writeback_slots(wc: int, p: int, pos_first: int):
    first = max(0, wc - p)
    return first, [(pos_first + i) % p for i in range(first, wc)]


def ring_writeback_reference(x, scl, fdl, scales, pos_first: int):
    """Plain :func:`ring_writeback`."""
    first, slots = _writeback_slots(x.shape[0], fdl.shape[1], pos_first)
    idx = torch.tensor(slots, device=fdl.device)
    fdl[:, idx] = x[first:].transpose(0, 1)
    if scales is not None:
        scales[idx] = scl[first:]
    return fdl


def ring_writeback(x, scl, fdl, scales, pos_first: int):
    """Staged rows into the ring, IN PLACE: block i of the window goes to
    slot ``(pos_first + i) % P`` (with its scale), the last write winning
    when the window is longer than the ring.

    x : [wc, 2, C, B] storage dtype; scl : [wc, C] f32 or None
    fdl : [2, P, C, B]; scales : [P, C] f32 or None
    """
    wc = x.shape[0]
    _, p, c, b = fdl.shape
    if x.dtype != fdl.dtype or tuple(x.shape[1:]) != (2, c, b) or (scl is None) != (scales is None):
        raise ValueError("ring_writeback: x must match the ring's dtype and [2, C, B] rows")
    if not 0 <= pos_first < p:
        raise ValueError(f"pos_first {pos_first} outside [0, {p})")
    if _check_common([x, scl, fdl, scales], "ring_writeback"):
        return ring_writeback_reference(x, scl, fdl, scales, pos_first)
    code = _build.load().neo_fs_writeback(
        STORAGE_CODES[fdl.dtype], x.data_ptr(), 0 if scl is None else scl.data_ptr(), fdl.data_ptr(),
        0 if scales is None else scales.data_ptr(), p, c, b, wc, pos_first, _build.stream_of(fdl),
    )
    _build.check(code, "ring_writeback")
    ring_writeback.launches += 1
    return fdl


ring_writeback.launches = 0


# ------------------------------------------------ the schedule's widths


def sched_widths_reference(sched, b: int, pc: int):
    """Plain :func:`sched_widths`."""
    c_idx, flags = (np.asarray(t.cpu()) for t in sched)
    p = c_idx.shape[0]
    n_codes = len(lane_widths(b))
    code, chunk = c_idx >> 16, c_idx & 0xFFFF
    width = np.where(flags == 1, np.where(code < n_codes, b >> np.minimum(code, 31), b), 0)
    tab = np.zeros((p, p // pc), np.int32)
    rows = np.broadcast_to(np.arange(p)[:, None], c_idx.shape)
    keep = chunk < p // pc
    np.maximum.at(tab, (rows[keep], chunk[keep]), width[keep].astype(np.int32))
    return torch.from_numpy(tab).to(sched[0].device)


def sched_widths(sched, b: int, pc: int):
    """The chunk schedule as live lane widths: ``[P, P / pc]`` int32, entry
    (row, j) the widest ``B >> code`` (B for a code outside ``lane_widths``)
    of row's flag-1 entries naming chunk j, 0 where none does."""
    c_idx, flags = sched
    p, l_max = c_idx.shape
    if p % pc:
        raise ValueError(f"pc = {pc} must divide P = {p}")
    if _check_common([c_idx, flags], "sched_widths"):
        return sched_widths_reference(sched, b, pc)
    tab = torch.empty((p, p // pc), dtype=torch.int32, device=c_idx.device)
    code = _build.load().neo_fs_widths(
        c_idx.data_ptr(), flags.data_ptr(), tab.data_ptr(), p, l_max, p // pc, b, len(lane_widths(b)),
        _build.stream_of(c_idx),
    )
    _build.check(code, "sched_widths")
    sched_widths.launches += 1
    return tab


sched_widths.launches = 0


# ------------------------------------------- 3. the time-batched MAC


def stream_mac_reference(fdl, scales, x, scl, filt_rim, dcfix, pos_first: int, seed=None, tiles=None,
                         out=None):
    """Plain :func:`stream_mac` (float64 sums, a loop over the window)."""
    _, p, c, b = fdl.shape
    wc = x.shape[0]
    old = [(pos_first + d) % p for d in range(-(p - 1), 0)]
    hist_old = fdl[:, torch.tensor(old, dtype=torch.long, device=fdl.device)].transpose(0, 1).double()
    hist_new = x.double()
    if scales is not None:
        hist_old = hist_old * _quant_scale(scales[old], fdl.dtype)[:, None, :, None]
        hist_new = hist_new * _quant_scale(scl, fdl.dtype)[:, None, :, None]
    hist = torch.cat([hist_old, hist_new])  # [P - 1 + wc, 2, C, B]: rows d = -(P-1) .. wc-1
    # block i reads hist rows i .. i+P-1 (d = i-P+1 .. i): row q is tap a = P-1-q, slot
    # (pos - a) % P, which meets filter row P-1-pos+slot: q when a <= pos, else q + P
    res = torch.empty((wc, c, 2 * b), dtype=torch.float32, device=fdl.device) if out is None else out
    q = torch.arange(p, device=fdl.device)
    tile_live = None
    if tiles is not None:  # row q: tap P-1-q's live lanes
        tile_live = tiles.bool().flip(0).repeat_interleave(_MAC_LANES, dim=1)[:, None, :b].to(fdl.device)
    for i in range(wc):
        xw = hist[i : i + p]
        pos = (pos_first + i) % p
        f = filt_rim[torch.where(p - 1 - q <= pos, q, q + p)].double()
        fr, fi = f[..., :b], f[..., b:]
        if tile_live is not None:
            fr = torch.where(tile_live, fr, 0.0)
            fi = torch.where(tile_live, fi, 0.0)
        acc_re = torch.sum(xw[:, 0] * fr - xw[:, 1] * fi, dim=0)
        acc_im = torch.sum(xw[:, 0] * fi + xw[:, 1] * fr, dim=0)
        if seed is not None:
            acc_re = acc_re + seed[i, 0].double()
            acc_im = acc_im + seed[i, 1].double()
        acc_re[:, 0] = dcfix[i, 0].double()
        acc_im[:, 0] = dcfix[i, 1].double()
        res[i] = torch.cat([acc_re, acc_im], dim=-1).float().to(filt_rim.dtype).float()
    return res


# stream_mac_kernel's tile (csrc/fused_step.cu: kLanes, kMB, kBlocks, kRows, kStages, kRing + kTail)
_MAC_LANES, _MAC_MB, _MAC_BLOCKS, _MAC_ROWS, _MAC_STAGES, _MAC_SLOTS = 8, 8, 64, 16, 3, 160


def stream_mac_geometry(p: int, c: int, b: int, wc: int, storage: torch.dtype, cf: int = 1,
                        nc: int = 1) -> dict:
    """Launch geometry of :func:`stream_mac`'s kernel for a ring [2, P, C, B]
    of the storage dtype ``storage``, a window of ``wc`` blocks and a filter
    of ``cf`` channels (1 or C); P sets the number of steps, not the tile.

    A CTA owns ``lanes`` lanes x ``channels`` channels x ``blocks`` blocks;
    ``grid`` = (lane tiles, channel tiles, block tiles). Its ``threads``
    are 8 warps: warp w the blocks [8 w, 8 w + 8) of the CTA's, thread t of
    a warp lane t % 8 and channels t // 8 % 4 + 4 q for q < ``nc``: 1 on
    the route without a table (per-channel filters keep each channel's
    taps; a shared filter over more than 4 channels takes the dense kernel,
    :func:`stream_mac_route`), 1 or 4 with one (the tiles kernel's, from
    :func:`stream_mac_plan`, which runs one cell of the grid a CTA).
    ``smem``: the dynamic shared bytes of the filter ring (``slots`` taps of
    both rim halves, matrix dtype) and ``stages`` stages of ``rows`` history
    rows (storage dtype, int scales); the kernel refuses any other count."""
    if storage not in MATRIX_DTYPES:
        raise ValueError(f"stream_mac_geometry: unknown storage {storage!r}")
    if cf not in (1, c):
        raise ValueError(f"stream_mac_geometry: cf = {cf} is neither 1 nor C = {c}")
    isz, msz = storage.itemsize, MATRIX_DTYPES[storage].itemsize
    if nc not in (1, 4) or (nc == 4 and cf != 1):
        raise ValueError(f"stream_mac_geometry: nc = {nc} with cf = {cf}")
    ct = 4 * nc
    ctf = 1 if cf == 1 else ct
    stage = _MAC_ROWS * 2 * ct * _MAC_LANES * isz + (_MAC_ROWS * ct * 4 if storage in _INT_MAX else 0)
    return {"lanes": _MAC_LANES, "channels": ct, "nc": nc, "blocks": _MAC_BLOCKS, "blocks_a_thread": _MAC_MB,
            "rows": _MAC_ROWS, "slots": _MAC_SLOTS, "stages": _MAC_STAGES, "threads": 32 * _MAC_BLOCKS // _MAC_MB,
            "grid": (-(-b // _MAC_LANES), -(-c // ct), -(-wc // _MAC_BLOCKS)),
            "smem": 4 * ctf * _MAC_SLOTS * _MAC_LANES * msz + _MAC_STAGES * stage}


# stream_mac_dense_kernel's tile (csrc/stream_mac_dense.cu: kLanes, kCt, kBlocks, kMB, kRows, kStages, kSlots)
_DENSE_CHANNELS, _DENSE_STAGES = 16, 4


def stream_mac_route(cf: int, c: int, tiles) -> str:
    """The kernel :func:`stream_mac` launches for ``c`` channels: ``"dense"``
    (``stream_mac_dense_kernel``) for a filter shared by the channels (``cf``
    = 1) over more than 4 channels without a tap-tile table, else ``"cta"``
    (``stream_mac_kernel``, or ``stream_mac_tiles_kernel`` with a table). At
    4 channels or fewer the dense kernel's 16-channel tile would be mostly
    idle, and ``stream_mac_kernel`` runs its 4-channel one."""
    return "dense" if cf == 1 and c > 4 and tiles is None else "cta"


def stream_mac_dense_geometry(p: int, c: int, b: int, wc: int, storage: torch.dtype) -> dict:
    """Launch geometry of :func:`stream_mac`'s dense route
    (:func:`stream_mac_route`) for a ring [2, P, C, B] of the storage dtype
    ``storage`` and a window of ``wc`` blocks; P sets the number of steps,
    not the tile.

    A CTA owns ``lanes`` lanes x ``channels`` channels x ``blocks`` blocks;
    ``grid`` = (lane tiles, channel tiles, block tiles). Its ``threads`` are
    8 warps: warp w the blocks [8 w, 8 w + 8) of the CTA's, thread t of a
    warp lanes 2 (t % 4) and 2 (t % 4) + 1 and channels t // 4 and t // 4 +
    8 of the tile. ``smem``: the dynamic shared bytes of the tap ring
    (``slots`` taps of both rim halves and planes, matrix dtype) and
    ``stages`` stages of ``rows`` history rows (storage dtype; int scales);
    the kernel refuses any other count."""
    if storage not in MATRIX_DTYPES:
        raise ValueError(f"stream_mac_dense_geometry: unknown storage {storage!r}")
    isz, msz = storage.itemsize, MATRIX_DTYPES[storage].itemsize
    ct = _DENSE_CHANNELS
    stage = _MAC_ROWS * 2 * ct * _MAC_LANES * isz + (_MAC_ROWS * ct * 4 if storage in _INT_MAX else 0)
    return {"lanes": _MAC_LANES, "channels": ct, "blocks": _MAC_BLOCKS, "blocks_a_thread": _MAC_MB,
            "lanes_a_thread": 2, "channels_a_thread": 2, "rows": _MAC_ROWS, "slots": _MAC_SLOTS,
            "stages": _DENSE_STAGES, "threads": 32 * _MAC_BLOCKS // _MAC_MB,
            "grid": (-(-b // _MAC_LANES), -(-c // ct), -(-wc // _MAC_BLOCKS)),
            "smem": 4 * _MAC_SLOTS * _MAC_LANES * msz + _DENSE_STAGES * stage}


def tap_tile_table(mask: np.ndarray, b: int) -> np.ndarray:
    """The tap-tile table of a keep-mask [P, K] or [P, C', K] (any channel)
    over the packed lanes of block B: bool ``[P, ceil(B / 8)]``, entry (a,
    t) True where the mask keeps a bin of lane tile t (lanes 8 t .. 8 t + 7,
    :func:`stream_mac`'s lanes a CTA) at partition a. Packed lane 0 also
    carries the Nyquist bin (column B), as in ``build_chunk_schedule``."""
    mask = np.asarray(mask, bool)
    if mask.ndim == 3:
        mask = mask.any(axis=1)
    p, k = mask.shape
    lanes = np.zeros((p, -(-b // _MAC_LANES) * _MAC_LANES), bool)
    lanes[:, : min(b, k)] = mask[:, :b]
    if k > b:
        lanes[:, 0] |= mask[:, b]
    return lanes.reshape(p, -1, _MAC_LANES).any(axis=2)


def _popcount8(v: np.ndarray) -> np.ndarray:
    return np.unpackbits(v[..., None], axis=-1).sum(-1, dtype=np.int64)


def _tile_steps(tiles: np.ndarray) -> np.ndarray:
    """uint8 ``[nt, ns]``: bit w of (t, s) set where warp w of a CTA of lane
    tile t (its blocks u0 .. u0 + 7) meets at step s (its history rows d0 ..
    d0 + 15) a tap a = u - d in [0, P) that the table keeps. u0 - d0 = 8 w +
    P - 1 - 16 s whatever the CTA's block tile, so one row serves them all;
    ns = the steps of a whole block tile."""
    p, nt = tiles.shape
    ns = (_MAC_BLOCKS + p - 2) // _MAC_ROWS + 1
    below = np.concatenate([np.zeros((1, nt), np.int64), np.cumsum(tiles, axis=0)])  # live taps < a
    out = np.zeros((nt, ns), np.uint8)
    for w in range(_MAC_BLOCKS // _MAC_MB):
        c = _MAC_MB * w + p - 1 - _MAC_ROWS * np.arange(ns)
        lo, hi = np.clip(c - (_MAC_ROWS - 1), 0, p), np.clip(c + _MAC_MB, 0, p)  # taps [lo, hi)
        out |= ((below[hi] - below[lo]) > 0).T.astype(np.uint8) << w
    return out


# The tiles kernel's cost model, in warp-steps of the NC = 4 variant: a term
# of NC = 1 costs 1.5 of NC = 4's (1.48-1.51 for the dense kernel at both on
# the H100, at the headline window), and each step a CTA walks about one more
# warp-step (its barrier and copies). Two CTAs an SM hold (128 registers a
# thread).
_NC1_TERM_COST, _WALK_STEP_COST, _CTAS_AN_SM = 1.5, 1.0, 2


def _makespan(cost: np.ndarray, slots: int) -> float:
    """When a list schedule of ``cost`` (in list order) on ``slots`` CTA
    slots ends, each item taking the slot that frees first."""
    if len(cost) <= slots:
        return float(cost.max(initial=0.0))
    heap = [0.0] * slots
    for v in cost.tolist():
        heapq.heapreplace(heap, heap[0] + v)
    return max(heap)


def stream_mac_plan(tiles: np.ndarray, c: int, wc: int, cf: int = 1, sms: int = 132) -> dict:
    """The scheduled walk of :func:`stream_mac` with a tap-tile table
    (:func:`tap_tile_table`, bool ``[P, nt]``) over C channels (a filter of
    ``cf`` channels) and a window of ``wc`` blocks, on a card of ``sms``
    SMs, built on the host:

    - ``steps`` uint8 ``[nt, ns]``: by lane tile and step of 16 history
      rows, the warps (8 blocks each) that meet a live tap there;
    - ``nc``: channels a thread, 1 or 4 (4 only with a shared filter and C
      > 4, as the dense kernel): the one whose list schedule ends first by
      the cost model above. NC = 1 splits a lane tile that carries most of
      the work (a perceptual mask's lowest bins, live at every tap) four
      times finer;
    - ``items`` int32 ``[n, 4]``: the work items, one a CTA, each (lane
      tile, channel tile of 4 ``nc``, block tile of 64) once, its last
      entry the steps it walks ``lo | hi << 16``, from its first to its
      last live step (both 0: none). Heaviest first, so the card starts
      them first and the light ones fill in;
    - ``steps_run`` / ``steps_dense``: the steps the walk runs (stages and
      computes) and those the dense kernel walks, each counted once a lane
      tile, block tile and channel.
    """
    p, nt = tiles.shape
    steps = _tile_steps(tiles)
    if steps.shape[1] >= 1 << 15:
        raise ValueError(f"stream_mac_plan: P = {p} is past the items' step fields")
    tile_z, span, warp_steps, walked = [], [], [], []
    run = dense = 0
    for z in range(-(-wc // _MAC_BLOCKS)):
        u_n = min(wc, (z + 1) * _MAC_BLOCKS) - z * _MAC_BLOCKS
        nsteps = (u_n + p - 2) // _MAC_ROWS + 1
        live = steps[:, :nsteps] & np.uint8((1 << -(-u_n // _MAC_MB)) - 1)  # the warps that hold blocks
        on = live != 0
        n_on = on.sum(1)
        lo = np.where(n_on > 0, np.argmax(on, axis=1), 0)
        hi = np.where(n_on > 0, nsteps - np.argmax(on[:, ::-1], axis=1), 0)
        run += int(n_on.sum()) * c
        dense += nsteps * nt * c
        tile_z.append(np.stack([np.arange(nt), np.full(nt, z)], axis=1))
        span.append(lo | hi << 16)
        warp_steps.append(_popcount8(live).sum(1))
        walked.append(hi - lo)
    tile_z, span = np.concatenate(tile_z), np.concatenate(span)
    warp_steps, walked = np.concatenate(warp_steps), np.concatenate(walked)
    best = None
    for nc in (4, 1) if cf == 1 and c > 4 else (1,):
        n_ct = -(-c // (4 * nc))
        term = 1.0 if nc == 4 else _NC1_TERM_COST / 4
        cost = np.repeat(warp_steps * term + walked * _WALK_STEP_COST, n_ct)
        order = np.argsort(-cost, kind="stable")
        ends = _makespan(cost[order], _CTAS_AN_SM * sms)
        if best is None or ends < best[0]:
            rows = np.repeat(np.arange(len(span)), n_ct)
            items = np.stack([tile_z[rows, 0], np.tile(np.arange(n_ct), len(span)), tile_z[rows, 1], span[rows]],
                             axis=1)
            best = (ends, nc, np.ascontiguousarray(items[order], dtype=np.int32))
    return {"steps": steps, "nc": best[1], "items": best[2], "steps_run": run, "steps_dense": dense}


# tap-tile tables seen by stream_mac: id -> (weakref, version, host table,
# {(C, wc, Cf): (steps, nc, items, steps_run, steps_dense), tensors on the card})
_TILE_PLANS: dict[int, tuple] = {}


def _tile_plan(tiles, c: int, wc: int, cf: int):
    """(steps, nc, items, steps_run, steps_dense) of :func:`stream_mac_plan`
    for a table on the card, built once a table (one copy to the host) and
    once a (C, wc, Cf): the render loop passes cached pointers."""
    entry = _TILE_PLANS.get(id(tiles))
    if entry is None or entry[0]() is not tiles or entry[1] != tiles._version:
        if len(_TILE_PLANS) > 64:
            _TILE_PLANS.clear()
        entry = _TILE_PLANS[id(tiles)] = (weakref.ref(tiles), tiles._version, tiles.cpu().numpy().astype(bool), {})
    plan = entry[3].get((c, wc, cf))
    if plan is None:
        dev = tiles.device
        got = stream_mac_plan(entry[2], c, wc, cf, torch.cuda.get_device_properties(dev).multi_processor_count)
        plan = entry[3][(c, wc, cf)] = (torch.from_numpy(got["steps"]).to(dev), got["nc"],
                                        torch.from_numpy(got["items"]).to(dev), got["steps_run"], got["steps_dense"])
    return plan


def _dense_steps(p: int, c: int, b: int, wc: int) -> int:
    """:func:`stream_mac_plan`'s ``steps_dense`` without a table."""
    nt = -(-b // _MAC_LANES)
    return sum((min(wc - u, _MAC_BLOCKS) + p - 2) // _MAC_ROWS + 1 for u in range(0, wc, _MAC_BLOCKS)) * nt * c


def _piece_bytes(segment: int, row_bytes: int, *tensors) -> int:
    """The largest cp.async piece (16, 8 or 4 bytes, at most ``segment``)
    that divides a row's bytes and every tensor's address; 0 for element
    copies."""
    for v in (16, 8, 4):
        if v <= segment and row_bytes % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    return 0


def _whole_pieces(piece: int, row_bytes: int, *tensors) -> int:
    """``piece`` where it divides a row's bytes and every tensor's address (the
    dense route's cp.async pieces), else 0 (element copies)."""
    return piece if row_bytes % piece == 0 and all(t.data_ptr() % piece == 0 for t in tensors) else 0


def stream_mac(fdl, scales, x, scl, filt_rim, dcfix, pos_first: int, seed=None, tiles=None, out=None):
    """The MAC of a window of blocks, batched over time.

    fdl, scales : the ring [2, P, C, B] and its scales [P, C] (or None) as
                  they stood before the window (slot ``(pos_first + d) % P``
                  holds the window's block d < 0)
    x, scl      : the window's staged rows [wc, 2, C, B] and scales [wc, C]
    filt_rim    : [2P, C', 2B] in the matrix dtype; block i at ring position
                  pos meets tap a (the slot written a blocks earlier) at row
                  P - 1 - a when a <= pos, else 2P - 1 - a: the rows the
                  block-by-block kernel reads, one filter when ``filt_rim``
                  is the tiled form the convolver builds
    dcfix       : [wc, 2, C] f32 lane-0 values; seed: [wc, 2, C, B] f32 or None
    tiles       : a tap-tile table uint8 [P, ceil(B / 8)] on the ring's
                  device (:func:`tap_tile_table`) or None (dense): tap a
                  adds nothing on lane k where entry (a, k // 8) is 0. The
                  card runs the scheduled walk of :func:`stream_mac_plan`
    returns acc [wc, C, 2B] f32: block i's ``seed + sum_a filt[a] X[i - a]``
    (each row dequantized with its own scale), lane 0 := dcfix, rounded to
    the matrix dtype

    :func:`stream_mac_route` picks the kernel. Each launch adds to
    ``stream_mac.steps_run`` the steps it runs and to
    ``stream_mac.steps_dense`` those the dense kernel walks, counted once a
    lane tile, block tile and channel (``stream_mac_plan``): equal amounts
    without a table.
    """
    _, p, c, b = fdl.shape
    wc = x.shape[0]
    if (tuple(x.shape) != (wc, 2, c, b) or x.dtype != fdl.dtype or tuple(dcfix.shape) != (wc, 2, c)
            or (seed is not None and tuple(seed.shape) != (wc, 2, c, b)) or (scl is None) != (scales is None)):
        raise ValueError("stream_mac: x [wc, 2, C, B], dcfix [wc, 2, C], seed [wc, 2, C, B] as the ring")
    _check_tiles(tiles, p, b)
    if _check_common([fdl, scales, x, scl, filt_rim, dcfix, seed, tiles, out], "stream_mac"):
        return stream_mac_reference(fdl, scales, x, scl, filt_rim, dcfix, pos_first, seed, tiles, out)
    if out is None:
        out = torch.empty((wc, c, 2 * b), dtype=torch.float32, device=fdl.device)
    cf = filt_rim.shape[1]
    isz, msz = fdl.element_size(), filt_rim.element_size()
    if stream_mac_route(cf, c, tiles) == "dense":
        run = dense = _dense_steps(p, c, b, wc)
        code = _build.load().neo_fs_stream_mac_dense(
            STORAGE_CODES[fdl.dtype], fdl.data_ptr(), 0 if scales is None else scales.data_ptr(), x.data_ptr(),
            0 if scl is None else scl.data_ptr(), filt_rim.data_ptr(), 0 if seed is None else seed.data_ptr(),
            dcfix.data_ptr(), out.data_ptr(), p, c, b, wc, pos_first,
            _whole_pieces(min(16, _MAC_LANES * isz), b * isz, fdl, x), _whole_pieces(16, b * msz, filt_rim),
            stream_mac_dense_geometry(p, c, b, wc, fdl.dtype)["smem"], _build.stream_of(fdl),
        )
    else:
        if tiles is None:
            steps = items = None
            nc = 1
            run = dense = _dense_steps(p, c, b, wc)
        else:
            steps, nc, items, run, dense = _tile_plan(tiles, c, wc, cf)
        geo = stream_mac_geometry(p, c, b, wc, fdl.dtype, cf, nc)
        code = _build.load().neo_fs_stream_mac(
            STORAGE_CODES[fdl.dtype], fdl.data_ptr(), 0 if scales is None else scales.data_ptr(), x.data_ptr(),
            0 if scl is None else scl.data_ptr(), filt_rim.data_ptr(), 0 if seed is None else seed.data_ptr(),
            dcfix.data_ptr(), 0 if tiles is None else tiles.data_ptr(), 0 if steps is None else steps.data_ptr(),
            0 if items is None else items.data_ptr(), out.data_ptr(), p, c, b, cf, wc, pos_first, geo["grid"][0],
            0 if steps is None else steps.shape[1], 0 if items is None else items.shape[0], nc,
            _piece_bytes(_MAC_LANES * isz, b * isz, fdl, x), _piece_bytes(_MAC_LANES * msz, b * msz, filt_rim),
            geo["smem"], _build.stream_of(fdl),
        )
    _build.check(code, "stream_mac")
    stream_mac.launches += 1
    stream_mac.steps_run += run
    stream_mac.steps_dense += dense
    return out


stream_mac.launches = 0
stream_mac.steps_run = 0
stream_mac.steps_dense = 0


# --------------------------------------------------- B2's one-block MAC


def _step_geometry(fdl):
    """(splits S, slots a split, lanes a thread) of :func:`step_mac`: the
    partition MAC's geometry, shared with B1 (``kernels.fdl_mac``)."""
    return step_geometry(*fdl.shape[1:], fdl.element_size())


def _step_aligned(fdl, filt_rim, vec: int) -> bool:
    """Whether the ring and the filter allow :func:`step_mac`'s ``vec``-lane
    loads (16 bytes of ring, ``vec`` filter elements)."""
    align = max(16, vec * filt_rim.element_size())
    return fdl.data_ptr() % 16 == 0 and filt_rim.data_ptr() % align == 0


def step_mac_reference(fdl, scales, filt_rim, pos: int, widths=None):
    """Plain :func:`step_mac` (float64 sums a split)."""
    _, p, c, b = fdl.shape
    s_n, per, _ = _step_geometry(fdl)
    part = torch.empty((s_n, 2, c, b), dtype=torch.float32, device=fdl.device)
    for s in range(s_n):
        sl = list(range(s * per, min(p, (s + 1) * per)))
        x = fdl[:, sl].double()
        if scales is not None:
            x = x * _quant_scale(scales[sl], fdl.dtype)[None, :, :, None]
        f = filt_rim[[p - 1 - pos + q for q in sl]].double()  # [n, C', 2B]
        fr, fi = f[..., :b], f[..., b:]
        if widths is not None:  # row pos of the width table: slot q keeps lanes k < width[pos, q // pc]
            w = widths[0][pos].cpu()[torch.as_tensor(sl) // widths[1]]
            live = (torch.arange(b)[None, :] < w[:, None]).to(f.device)[:, None, :]
            fr = torch.where(live, fr, 0.0)
            fi = torch.where(live, fi, 0.0)
        part[s, 0] = torch.sum(x[0] * fr - x[1] * fi, dim=0).float()
        part[s, 1] = torch.sum(x[0] * fi + x[1] * fr, dim=0).float()
    return part


def step_mac(fdl, scales, filt_rim, pos: int, widths=None):
    """One block's MAC against the ring (B2), split over P.

    fdl, scales : the ring [2, P, C, B] with the new row already in slot
                  ``pos``, and its scales [P, C] (or None)
    filt_rim    : [2P, C', 2B] matrix dtype; slot p meets row P - 1 - pos + p
    widths      : ``(sched_widths(...), pc)`` or None; row ``pos`` is read
    returns part [S, 2, C, B] f32, split s the sum over its slots
    """
    _, p, c, b = fdl.shape
    tab = None if widths is None else widths[0]
    if _check_common([fdl, scales, filt_rim, tab], "step_mac"):
        return step_mac_reference(fdl, scales, filt_rim, pos, widths)
    s_n, per, vec = _step_geometry(fdl)
    cf = filt_rim.shape[1]
    msize = filt_rim.element_size()
    fre = filt_rim[p - 1 - pos]
    if vec > 1 and not _step_aligned(fdl, filt_rim, vec):
        vec = 1
    part = torch.empty((s_n, 2, c, b), dtype=torch.float32, device=fdl.device)
    code = _build.load().neo_fs_step_mac(
        STORAGE_CODES[fdl.dtype], fdl.data_ptr(), 0 if scales is None else scales.data_ptr(),
        fre.data_ptr(), fre.data_ptr() + b * msize, cf * 2 * b, 0 if cf == 1 else 2 * b,
        0 if tab is None else tab[pos].data_ptr(), part.data_ptr(),
        p, c, b, 1 if widths is None else widths[1], s_n, per, vec, _build.stream_of(fdl),
    )
    _build.check(code, "step_mac")
    step_mac.launches += 1
    return part


step_mac.launches = 0


def step_reduce_reference(part, dcfix, mdt):
    """Plain :func:`step_reduce`."""
    acc = part.double().sum(0)  # [2, C, B]
    acc[:, :, 0] = dcfix.double()
    return torch.cat([acc[0], acc[1]], dim=-1).float().to(mdt).float()[None]


def step_reduce(part, dcfix, mdt):
    """B2's accumulator: the splits of :func:`step_mac` added in split order,
    lane 0 := ``dcfix`` [2, C], rounded to the matrix dtype ``mdt``.
    returns acc [1, C, 2B] f32"""
    s_n, _, c, b = part.shape
    if tuple(dcfix.shape) != (2, c) or dcfix.dtype != torch.float32:
        raise ValueError(f"dcfix must be float32 [2, {c}]")
    if _check_common([part, dcfix], "step_reduce"):
        return step_reduce_reference(part, dcfix, mdt)
    acc = torch.empty((1, c, 2 * b), dtype=torch.float32, device=part.device)
    code = _build.load().neo_fs_step_reduce(
        int(mdt == torch.bfloat16), part.data_ptr(), dcfix.data_ptr(), acc.data_ptr(), s_n, c, b,
        _build.stream_of(part),
    )
    _build.check(code, "step_reduce")
    step_reduce.launches += 1
    return acc


step_reduce.launches = 0


# the stages neo_fused_block_step launches, in the order of its counts
_STEP_STAGES = (window_forward, quantize_rows, ring_writeback, sched_widths, step_mac, step_reduce,
                window_inverse)


def stage_wrappers():
    """The stage functions of B2 and B3, each counting its launches."""
    return (window_forward, quantize_rows, stream_mac, ring_writeback, window_inverse, sched_widths,
            step_mac, step_reduce)


# ------------------------------------------------------ the block oracle


def _sched_live(sched, pos, p, b, pc):
    """[P, B] bool: the (row, lane) pairs that row ``pos`` of the chunk
    schedule sums (the block-by-block oracle's form of the schedule)."""
    n_codes = len(lane_widths(b))
    live = torch.zeros((p, b), dtype=torch.bool)
    for v, fl in zip(sched[0][pos].tolist(), sched[1][pos].tolist()):
        if fl == 1:
            code = v >> 16
            cj = v & 0xFFFF
            live[cj * pc : (cj + 1) * pc, : b >> code if code < n_codes else b] = True
    return live


def _block_reference(frame, fdl, scales, rim, pos, dcfix, fwd, inv, seed=None, sched=None):
    """One block of the fused pipeline in plain PyTorch. fwd [N, 2B] and
    inv [2B, n_out] in the matrix dtype; ``seed`` [2, C, B] f32 starts the
    MAC sum (B3's ``acc_add``); ``sched`` (c_idx, flags) limits the MAC to
    row ``pos``'s chunks and lanes; updates fdl/scales row ``pos``."""
    p, b = fdl.shape[1], fdl.shape[3]
    spec = (frame.to(fwd.dtype).double() @ fwd.double()).to(torch.float32)  # [C, 2B]
    spec = torch.stack([spec[:, :b], spec[:, b:]])  # [2, C, B]
    if scales is not None:
        m = _INT_MAX[fdl.dtype]
        peak = torch.amax(torch.abs(spec), dim=(0, 2))
        scale = torch.where(peak > 0, peak, torch.ones_like(peak))
        q = torch.clamp(torch.round(spec / scale[None, :, None] * m), -m, m)
        fdl[:, pos] = q.to(fdl.dtype)
        scales[pos] = scale
    else:
        fdl[:, pos] = spec.to(fdl.dtype)

    rot = rim[p - 1 - pos : 2 * p - 1 - pos].double()  # [P, C', 2B]
    x = fdl.double()
    if scales is not None:
        x = x * _quant_scale(scales, fdl.dtype)[None, :, :, None]
    fr, fi = rot[..., :b], rot[..., b:]
    if sched is not None:
        live = _sched_live(sched, pos, p, b, fused_chunk_rows(fdl.dtype, p, fdl.shape[2], b))
        live = live.to(rot.device)[:, None, :]
        fr = torch.where(live, fr, 0.0)
        fi = torch.where(live, fi, 0.0)
    acc_re = torch.sum(x[0] * fr - x[1] * fi, dim=0)
    acc_im = torch.sum(x[0] * fi + x[1] * fr, dim=0)
    if seed is not None:
        acc_re = acc_re + seed[0].double()
        acc_im = acc_im + seed[1].double()
    acc_re[:, 0] = dcfix[0].double()
    acc_im[:, 0] = dcfix[1].double()
    accp = torch.cat([acc_re, acc_im], dim=-1).to(torch.float32).to(inv.dtype)
    return (accp.double() @ inv.double()).to(torch.float32)


def fused_block_step_reference(frame, fdl, filt_rim, pos, dcfix, cs, ab, scales=None, sched=None):
    """Plain PyTorch B2, block by block (the oracle); same contract as
    :func:`fused_block_step`."""
    b = fdl.shape[3]
    fwd = torch.cat([cs[0], cs[1]], dim=-1)  # [N, 2B]
    inv = ab.reshape(2 * b, -1)  # [2B, N]
    y = _block_reference(frame, fdl, scales, filt_rim, int(pos), dcfix, fwd, inv, sched=sched)
    return (y, fdl) if scales is None else (y, fdl, scales)


def fused_stream_reference(sigpad, fdl, filt_rim, pos0, dcfix_all, cs, abt, scales=None,
                           sched=None, acc_add=None):
    """Plain PyTorch B3, a Python loop over blocks (the oracle); the
    contract of :func:`fused_stream`, with a sparse filter's chunk schedule
    ``sched`` (as :func:`fused_block_step`'s; block i honours row ``(pos0 +
    i) % P``) in place of its tap-tile table."""
    c = sigpad.shape[0]
    p, b = fdl.shape[1], fdl.shape[3]
    nb = sigpad.shape[1] // b - 1
    out = torch.empty((c, nb * b), dtype=torch.float32, device=sigpad.device)
    for i in range(nb):
        frame = sigpad[:, i * b : i * b + 2 * b]
        pos = (int(pos0) + i) % p
        out[:, i * b : (i + 1) * b] = _block_reference(
            frame, fdl, scales, filt_rim, pos, dcfix_all[i], cs, abt,
            None if acc_add is None else acc_add[i], sched,
        )
    return (out, fdl) if scales is None else (out, fdl, scales)


# ------------------------------------------------------------ B2 and B3


def fused_block_step(frame, fdl, filt_rim, pos, dcfix, cs, ab, scales=None, sched=None):
    """One fused streaming block step over the packed-layout ring FDL.

    frame   : [C, N] f32 (UPOLS sliding window / UPOLA zero-padded block)
    fdl     : [2, P, C, B] storage dtype, ring layout — row ``pos`` is
              written IN PLACE
    filt_rim: [2P, C', 2B] lane-packed re|im tiled-reversed filter, C' in
              {1, C}, matrix dtype (``MATRIX_DTYPES``)
    pos     : int ring write position
    dcfix   : [2, C] f32 exact DC/Nyquist accumulator values
    cs      : [2, N, B] forward packed-DFT matrices (cos | sin)
    ab      : [2, B, N] inverse packed-DFT matrices (1/N folded)
    scales  : [P, C] f32 (int8/int16 storages only) — row ``pos`` written
              in place
    sched   : optional chunk schedule ``(c_idx, flags)``, the full [P, L]
              int32 tables (module docstring); row ``pos`` is honoured

    Returns (y [C, N] f32, fdl) or (y, fdl, scales).
    """
    with trace.span("kernels.block_step"):
        if frame.ndim != 2 or frame.dtype != torch.float32:
            raise ValueError(f"frame must be float32 [C, N], got {frame.dtype} {tuple(frame.shape)}")
        c, n = frame.shape
        p, b, mdt = _check_ring(fdl, filt_rim, scales, c)
        pos = int(pos)
        if n != 2 * b or not 0 <= pos < p:
            raise ValueError(f"frame length {n} != 2B = {2 * b}, or pos {pos} outside [0, {p})")
        if cs.dtype != mdt or ab.dtype != mdt or tuple(cs.shape) != (2, n, b) or tuple(ab.shape) != (2, b, n):
            raise ValueError(f"cs/ab must be {mdt} [2, {n}, {b}] / [2, {b}, {n}]")
        if dcfix.dtype != torch.float32 or tuple(dcfix.shape) != (2, c):
            raise ValueError(f"dcfix must be float32 [2, {c}]")
        cpu = _check_common([frame, fdl, filt_rim, dcfix, cs, ab, scales], "fused_block_step")
        pc = _check_sched(sched, fdl)
        _check_dft(cs, n, inverse=False)
        _check_dft(ab, n, inverse=True)
        if cpu:  # the staged plain versions
            spec = window_forward(frame, cs, 0, 1)
            x, scl = quantize_rows(spec, fdl.dtype)
            ring_writeback(x, scl, fdl, scales, pos)
            widths = None if sched is None else (sched_widths(sched, b, pc), pc)
            acc = step_reduce(step_mac(fdl, scales, filt_rim, pos, widths), dcfix, mdt)
            y = window_inverse(acc, ab.reshape(2 * b, n), torch.empty((c, n), dtype=torch.float32), 0)
            return (y, fdl) if scales is None else (y, fdl, scales)
        # the same stage kernels, launched by one C call: a block's device time
        # is about 0.1 ms, less than a host round trip per stage would cost
        s_n, per, vec = _step_geometry(fdl)
        if vec > 1 and not _step_aligned(fdl, filt_rim, vec):
            vec = 1
        # the staging regions, 256-byte aligned in one buffer (one allocation a
        # call: each torch.empty costs host time on a ~0.1 ms step): spec, the
        # staged row, its scales, step_mac's partial sums, the accumulator, the
        # widths table; 0 bytes where absent
        sizes = (4 * c * n, 2 * c * b * fdl.element_size(), 4 * c if scales is not None else 0,
                 4 * s_n * 2 * c * b, 4 * c * n, 4 * p * (p // pc) if sched is not None else 0)
        offsets, total = [], 0
        for size in sizes:
            offsets.append(total if size else None)
            total += -(-size // 256) * 256
        ws = torch.empty(total, dtype=torch.uint8, device=frame.device)
        spec, x, scl, mpart, acc, tab = (0 if o is None else ws.data_ptr() + o for o in offsets)
        y = torch.empty((c, n), dtype=torch.float32, device=frame.device)
        c_idx, c_flags = (0, 0) if sched is None else (sched[0].data_ptr(), sched[1].data_ptr())
        counts = (ctypes.c_int * len(_STEP_STAGES))()  # the C call adds one per stage it launched
        code = _build.load().neo_fused_block_step(
            STORAGE_CODES[fdl.dtype], frame.data_ptr(), fdl.data_ptr(), filt_rim.data_ptr(),
            0 if scales is None else scales.data_ptr(), dcfix.data_ptr(), twiddles(n, frame.device).data_ptr(),
            y.data_ptr(), c_idx, c_flags, spec, x, scl, mpart, acc, tab, counts, p, c, b,
            filt_rim.shape[1], pos, 0 if sched is None else sched[0].shape[1], pc or 1, len(lane_widths(b)),
            s_n, per, vec, _build.stream_of(frame),
        )
        for stage, launched in zip(_STEP_STAGES, counts):
            stage.launches += launched
        _build.check(code, "fused_block_step")
        fused_block_step.launches += 1
        fused_block_step.sched_launches += sched is not None
        return (y, fdl) if scales is None else (y, fdl, scales)


fused_block_step.launches = 0
fused_block_step.sched_launches = 0


def fused_stream(sigpad, fdl, filt_rim, pos0, dcfix_all, cs, abt, scales=None,
                 tiles=None, acc_add=None):
    """Stream nb UPOLS blocks through the staged pipeline, in windows of
    :data:`WINDOW` blocks.

    sigpad   : [C, (nb+1)*B] f32 — [previous tail | signal]
    fdl      : [2, P, C, B] storage dtype, ring layout — updated IN PLACE
    filt_rim : as :func:`fused_block_step`
    pos0     : int ring write position of the FIRST block
    dcfix_all: [nb, 2, C] f32 per-block exact DC/Nyquist accumulators
               (``conv.convolver._dcfix_sequence``)
    cs       : [N, 2B] forward packed-DFT matrix, cos|sin lane-packed
    abt      : [2B, B] inverse matrix, last-B columns only (tail half)
    scales   : [P, C] f32 (int8/int16) — updated IN PLACE
    tiles    : optional tap-tile table uint8 [P, ceil(B / 8)] of the mask
               (:func:`tap_tile_table`; ``params["tap_tiles"]``): the MAC
               skips the (tap, lane tile) pairs it marks dead, and the
               windows are :data:`TILES_WINDOWS` times longer
    acc_add  : optional [nb, 2, C, B] f32 per-block accumulator SEED
               (packed lanes; the MAC adds onto it, and the ``dcfix``
               overwrite of lane 0 comes after, so lane 0 of the seed is
               ignored). The hybrid engine's chunk-rate tail sum enters
               its per-block head through it (linearity of the sum).

    Returns (out [C, nb*B] f32, fdl) or (out, fdl, scales). On the card
    ``fused_stream.launches`` counts the calls and
    ``fused_stream.sched_launches`` those with a table.
    """
    with trace.span("kernels.fused_stream"):
        if sigpad.ndim != 2 or sigpad.dtype != torch.float32:
            raise ValueError(f"sigpad must be float32 [C, (nb+1)*B], got {sigpad.dtype} {tuple(sigpad.shape)}")
        c = sigpad.shape[0]
        p, b, mdt = _check_ring(fdl, filt_rim, scales, c)
        if sigpad.shape[1] % b or sigpad.shape[1] < 2 * b:
            raise ValueError(f"sigpad length {sigpad.shape[1]} is not (nb+1)*B with nb >= 1")
        nb = sigpad.shape[1] // b - 1
        n = 2 * b
        if cs.dtype != mdt or abt.dtype != mdt or tuple(cs.shape) != (n, 2 * b) or tuple(abt.shape) != (2 * b, b):
            raise ValueError(f"cs/abt must be {mdt} [{n}, {2 * b}] / [{2 * b}, {b}]")
        if dcfix_all.dtype != torch.float32 or tuple(dcfix_all.shape) != (nb, 2, c):
            raise ValueError(f"dcfix_all must be float32 [{nb}, 2, {c}]")
        if acc_add is not None and (acc_add.dtype != torch.float32
                                    or tuple(acc_add.shape) != (nb, 2, c, b)):
            raise ValueError(f"acc_add must be float32 [{nb}, 2, {c}, {b}]")
        _check_tiles(tiles, p, b)
        pos0 = int(pos0) % p
        cpu = _check_common([sigpad, fdl, filt_rim, dcfix_all, cs, abt, scales, acc_add, tiles], "fused_stream")
        _check_dft(cs, n, inverse=False)
        _check_dft(abt, n, inverse=True)

        dev = sigpad.device
        out = torch.empty((c, nb * b), dtype=torch.float32, device=dev)
        window = WINDOW if tiles is None else WINDOW * TILES_WINDOWS
        w = min(window, nb)  # staging, reused by every window
        spec = torch.empty((w, c, 2 * b), dtype=torch.float32, device=dev)
        x = torch.empty((w, 2, c, b), dtype=fdl.dtype, device=dev)
        scl = None if scales is None else torch.empty((w, c), dtype=torch.float32, device=dev)
        acc = torch.empty((w, c, 2 * b), dtype=torch.float32, device=dev)
        for i0 in range(0, nb, window):
            wc = min(window, nb - i0)
            pos_first = (pos0 + i0) % p
            s_w = None if scl is None else scl[:wc]
            window_forward(sigpad, cs, i0, wc, out=spec[:wc])
            quantize_rows(spec[:wc], fdl.dtype, x[:wc], s_w)
            stream_mac(fdl, scales, x[:wc], s_w, filt_rim, dcfix_all[i0 : i0 + wc], pos_first,
                       None if acc_add is None else acc_add[i0 : i0 + wc], tiles, acc[:wc])
            ring_writeback(x[:wc], s_w, fdl, scales, pos_first)
            window_inverse(acc[:wc], abt, out, i0)
        if not cpu:
            fused_stream.launches += 1
            fused_stream.sched_launches += tiles is not None
        return (out, fdl) if scales is None else (out, fdl, scales)


fused_stream.launches = 0
fused_stream.sched_launches = 0
