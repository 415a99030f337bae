"""Chunked (multi-block) partitioned convolution on PyTorch and CUDA: the
throughput engine for shared filters. Port of ``neojax.conv.chunked``.

The per-block step re-reads the whole delay line every block for an
elementwise MAC. This engine processes ``S`` blocks per step and writes
the partition MAC as a *batched Toeplitz product* over frequency bins:

    acc[s, c, k] = sum_j filt[j, k] * spec[t + s - j, c, k]
                 = sum_m T_k[s, m] * hist[m, c, k]

where ``hist`` holds the last ``M = P + S - 1`` spectra (read once per
chunk) and ``T_k`` is the [S, M] Toeplitz form of bin k's partition
sequence, built once with the filter. The complex structure folds into
one real batched product per chunk, ``[K, 2S, 2M] @ [K, 2M, C]``:
``torch.bmm`` (cuBLAS) — the JAX package also runs this product outside
any Pallas kernel (``neojax/conv/chunked.py:38-41``).

Sparsity maps to *banded buckets*: bin k has a band ``P_k`` = last kept
partition + 1; bins are grouped into at most ``num_buckets`` buckets by
band, and each bucket carries and contracts only its largest band.
Fully masked bins output exact zeros.

Dtypes: ``"bf16"`` stores the Toeplitz operand and the history in bf16,
the product accumulating in float32 (``torch.bmm(..., out_dtype=
torch.float32)`` on the card; on the CPU both operands are widened to
float32, exact for bf16 values), and rounds its transform operands to bf16
(``matmul_backend.round_operand``, the JAX package's ``DEFAULT``). Every
other storage runs in float32, the product in IEEE float32 under
``core.device.ieee_float32`` (``HIGHEST``). Shared (single-channel)
filters only, by design, as in the JAX package.

Dict keys and shapes are the JAX package's: params ``{"buckets": ({"tcat"
[Kb, 2S, 2M], "bins" int32 [Kb], "band" int}, ...)}``, state ``{"tail"
[C, B] f32, "hists": ([Kb, 2M, C], ...)}``. ``process_chunked`` **writes
the hists in place** (the state passed in shares them with the state
returned).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neojax_torch.conv.convolver import PartitionedConfig, _canon_partitions, _host
from neojax_torch.core.device import ieee_float32, resolve_device
from neojax_torch.fft import matmul_backend as mb

__all__ = [
    "chunked_filter_params",
    "chunked_init_state",
    "process_chunked",
]


def _toeplitz(filt_plane: np.ndarray, s: int) -> np.ndarray:
    """[P, K] filter plane -> [K, S, P+S-1] Toeplitz bands.

    T[k, s, m] = filt[P-1+s-m, k] for the index in [0, P), else 0. The
    host build (``neojax.conv.chunked._toeplitz``); :func:`_toeplitz_fold`
    builds the same operand on the device.
    """
    p, k = filt_plane.shape
    m_len = p + s - 1
    t = np.zeros((k, s, m_len), filt_plane.dtype)
    fk = filt_plane.T  # [K, P]
    for row in range(s):
        t[:, row, row : row + p] = fk[:, ::-1]
    return t


def _fold_tcat(t_re: np.ndarray, t_im: np.ndarray) -> np.ndarray:
    """Fold complex structure: [[Tr, -Ti], [Ti, Tr]] -> [K, 2S, 2M] (host)."""
    top = np.concatenate([t_re, -t_im], axis=2)
    bot = np.concatenate([t_im, t_re], axis=2)
    return np.concatenate([top, bot], axis=1)


def _toeplitz_fold(sub_re: torch.Tensor, sub_im: torch.Tensor, s: int, dtype: torch.dtype) -> torch.Tensor:
    """``_fold_tcat(_toeplitz(re, s), _toeplitz(im, s))`` as ``dtype`` on
    the planes' device, by an index gather: [band, Kb] float32 planes ->
    [Kb, 2S, 2M]. Every entry is a copy (or the negation) of a filter
    value or a zero, so it equals the host build bit for bit, negative
    zeros of the ``-Ti`` quadrant included. Builds one quadrant at a time
    (the operand is 1.1 GB in float32 at 64 channels x 938 partitions x
    S = 128)."""
    band, kb = sub_re.shape
    m = band + s - 1
    dev = sub_re.device
    # T[k, row, col] = rev[k, col - row] for 0 <= col - row < band, else the
    # zero appended at index ``band``
    idx = torch.arange(m, device=dev)[None, :] - torch.arange(s, device=dev)[:, None]  # [S, M]
    idx = torch.where((idx >= 0) & (idx < band), idx, band)
    tcat = torch.empty((kb, 2 * s, 2 * m), dtype=dtype, device=dev)
    for plane, quadrants in ((sub_re, ((0, 0, 1), (1, 1, 1))), (sub_im, ((0, 1, -1), (1, 0, 1)))):
        rev = torch.cat([plane.T.flip(1), plane.new_zeros((kb, 1))], dim=1)  # [Kb, band + 1]
        t = rev[:, idx]  # [Kb, S, M]
        for qr, qc, sign in quadrants:
            tcat[:, qr * s : (qr + 1) * s, qc * m : (qc + 1) * m] = t if sign > 0 else -t
        del t
    return tcat


def _bucket_bands(bands: np.ndarray, num_buckets: int) -> list[np.ndarray]:
    """Group bin indices by band length into <= num_buckets groups.

    Returns a list of int32 index arrays (bins with band 0 are excluded —
    their output is exactly zero).
    """
    active = np.nonzero(bands > 0)[0]
    if active.size == 0:
        return []
    vals = bands[active]
    order = np.argsort(vals, kind="stable")
    groups = np.array_split(order, min(num_buckets, active.size))
    return [np.sort(active[g]).astype(np.int32) for g in groups if g.size]


def _dtype(config: PartitionedConfig) -> torch.dtype:
    return torch.bfloat16 if config.storage == "bf16" else torch.float32


def chunked_filter_params(config: PartitionedConfig, partitions, chunk_blocks: int, mask=None,
                          num_buckets: int = 4, device=None) -> dict:
    """Build (optionally banded-sparse) Toeplitz filter params on ``device``
    (None: the card). The bands and buckets are found on the host; the
    Toeplitz operands are gathered on ``device`` (:func:`_toeplitz_fold`).

    ``mask``: optional boolean [P, K] (or [1, P, K] / [C', P, K] any-OR)
    keep-mask — the sparsity predicate output (``conv.sparse``).
    """
    device = resolve_device(device)
    filt = _canon_partitions(config, _host(partitions)).astype(np.complex64)
    if filt.shape[1] != 1:
        raise ValueError(
            "chunked mode is shared-IR only by design: a per-channel Toeplitz "
            "operand would be [K, C, 2S, 2M] (terabytes at production sizes). "
            "Use the nested engine for per-channel filters — same throughput "
            "class (conv.nested.nested_filter_params)."
        )
    plane = filt[:, 0, :]  # [P, K]
    p, k = plane.shape
    s = chunk_blocks

    if mask is not None:
        m = np.asarray(_host(mask), bool)
        if m.ndim == 3:
            m = m.any(axis=0) if m.shape[0] != p else m  # [C',P,K] -> [P,K]
        if m.shape != (p, k):
            raise ValueError(f"mask shape {m.shape} != ({p}, {k})")
        plane = np.where(m, plane, 0)
        bands = np.where(m.any(axis=0), 1 + np.argmax(
            np.where(m, np.arange(p)[:, None], -1), axis=0), 0)
        # bands[k] = last kept partition + 1, or 0 if the bin is fully masked
        bucket_bins = _bucket_bands(bands.astype(np.int64), num_buckets)
    else:
        bucket_bins = [np.arange(k, dtype=np.int32)]
        bands = np.full(k, p)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    buckets = []
    for bins in bucket_bins:
        band = int(bands[bins].max())
        sub = plane[:band, :][:, bins]  # [band, Kb]
        tcat = _toeplitz_fold(put(np.real(sub).astype(np.float32)), put(np.imag(sub).astype(np.float32)),
                              s, _dtype(config))
        buckets.append({"tcat": tcat, "bins": put(bins), "band": band})
    return {"buckets": tuple(buckets)}


def chunked_init_state(config: PartitionedConfig, params: dict, device=None) -> dict:
    """State = overlap tail + per-bucket spectrum windows, on ``device``
    (None: the params' device).

    Each window is the product operand ``[Kb, 2M, C]`` (re frames
    oldest->newest at [0:M], im at [M:2M], M = band + S - 1, the newest S
    frames being the current chunk), so the per-chunk update is one
    shift-concat.
    """
    buckets = params["buckets"]
    if device is None:
        device = buckets[0]["tcat"].device if buckets else resolve_device(None)
    c = config.channels
    hists = tuple(
        torch.zeros((b["bins"].shape[0], b["tcat"].shape[2], c), dtype=_dtype(config), device=device)
        for b in buckets
    )
    return {"tail": torch.zeros((c, config.block_size), dtype=torch.float32, device=device),
            "hists": hists}


def _fft_precisions(config: PartitionedConfig) -> tuple[str, str]:
    """(forward, inverse) transform precision (``mb.PRECISIONS``): bf16 at
    DEFAULT (its transform operands rounded to bf16), the others at
    HIGHEST (float32 FFTs), as ``neojax.conv.chunked._fft_precisions``."""
    if config.storage == "bf16":
        return ("default", "default")
    return ("highest", "highest")


def _bucket_product(tcat: torch.Tensor, hwin: torch.Tensor) -> torch.Tensor:
    """[Kb, 2S, 2M] @ [Kb, 2M, C] -> [Kb, 2S, C] float32: IEEE float32 for
    float32 operands; bf16 operands accumulate in float32, never rounded
    to bf16."""
    if tcat.dtype == torch.bfloat16:
        if tcat.is_cuda:
            return torch.bmm(tcat, hwin, out_dtype=torch.float32)
        return torch.bmm(tcat.float(), hwin.float())
    with ieee_float32():
        return torch.bmm(tcat, hwin)


def _shift_window(hwin: torch.Tensor, new_re: torch.Tensor, new_im: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Advance a bucket's window [Kb, 2M, C] by S = new_re.shape[1] blocks
    into ``out``: each half (re | im) drops its oldest S rows and takes the
    new [Kb, S, C] spectra at its end (one shift-concat)."""
    s = new_re.shape[1]
    m = hwin.shape[1] // 2
    torch.cat([hwin[:, s:m], new_re, hwin[:, m + s :], new_im], dim=1, out=out)


def process_chunked(config: PartitionedConfig, params: dict, state: dict, signal,
                    chunk_blocks: int):
    """Process [C, T] (or [T]) through the Toeplitz-product path, S blocks
    per step.

    T is padded up to a multiple of S*B (output trimmed; the returned state
    reflects the padded stream — use the per-block path when exact mid-
    stream state semantics matter). Returns (new_state, out); the hists
    are updated in place.
    """
    b = config.block_size
    n = config.transform_size
    k = config.num_bins
    s = chunk_blocks
    buckets = params["buckets"]
    tail, hists = state["tail"], state["hists"]
    hist_dtype = hists[0].dtype if hists else torch.float32
    fwd_prec, inv_prec = _fft_precisions(config)

    signal = torch.as_tensor(signal).to(device=tail.device, dtype=torch.float32)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]
    c, t_len = signal.shape
    num_chunks = -(-t_len // (s * b))
    padded = F.pad(signal, (0, num_chunks * s * b - t_len))
    chunks = padded.reshape(c, num_chunks, s, b)

    # Each window advances by one shift-concat into a second buffer; the
    # two swap every chunk (one extra copy alive), and the last chunk's
    # window is copied back into the caller's buffer if it ended there.
    bins = [bk["bins"].long() for bk in buckets]
    full = [bk["bins"].shape[0] == k for bk in buckets]  # covers every bin, in order
    cur = list(hists)
    spare = [torch.empty_like(h) for h in hists]
    outs = []
    for i in range(num_chunks):
        chunk = chunks[:, i].transpose(0, 1)  # [S, C, B]
        if config.scheme == "upols":
            prev = torch.cat([tail[None], chunk[:-1]], dim=0)
            frames = torch.cat([prev, chunk], dim=-1)  # [S, C, 2B]
            new_tail = chunk[-1]
        else:  # upola
            frames = F.pad(chunk, (0, n - b))

        spec_re, spec_im = mb.rfft_split(mb.round_operand(frames, fwd_prec), n)  # [S, C, K]
        kre = spec_re.permute(2, 0, 1).to(hist_dtype)  # K-major: [K, S, C]
        kim = spec_im.permute(2, 0, 1).to(hist_dtype)

        acc_re = acc_im = None
        if not all(full):
            acc_re = torch.zeros((k, s, c), dtype=torch.float32, device=tail.device)
            acc_im = torch.zeros_like(acc_re)
        for j, bucket in enumerate(buckets):
            new_re = kre if full[j] else kre.index_select(0, bins[j])  # [Kb, S, C]
            new_im = kim if full[j] else kim.index_select(0, bins[j])
            hwin, nxt = cur[j], spare[j]
            _shift_window(hwin, new_re, new_im, nxt)
            cur[j], spare[j] = nxt, hwin
            out_cat = _bucket_product(bucket["tcat"], nxt)  # [Kb, 2S, C]
            if full[j]:
                acc_re, acc_im = out_cat[:, :s], out_cat[:, s:]
            else:
                acc_re.index_copy_(0, bins[j], out_cat[:, :s])
                acc_im.index_copy_(0, bins[j], out_cat[:, s:])
        if acc_re is None:  # no bucket: every bin is masked
            acc_re = acc_im = torch.zeros((k, s, c), dtype=torch.float32, device=tail.device)

        # back to [S, C, K] for the inverse transform
        y = mb.irfft_split(mb.round_operand(acc_re.permute(1, 2, 0), inv_prec),
                           mb.round_operand(acc_im.permute(1, 2, 0), inv_prec), n)  # [S, C, 2B]
        if config.scheme == "upols":
            out = y[..., b:]
        else:
            prev_tails = torch.cat([tail[None], y[:-1, :, b:]], dim=0)
            out = y[..., :b] + prev_tails
            new_tail = y[-1, :, b:]
        outs.append(out)
        tail = new_tail.to(torch.float32).clone()

    for j, h in enumerate(hists):
        if cur[j] is not h:
            h.copy_(cur[j])
    if num_chunks:
        out = torch.stack(outs).permute(2, 0, 1, 3).reshape(c, num_chunks * s * b)[:, :t_len]
    else:
        out = signal[:, :0]
    return {"tail": tail, "hists": hists}, (out[0] if squeeze else out)
