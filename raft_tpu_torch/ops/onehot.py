"""One-hot gather/scatter/sort primitives for small index domains
(raft_tpu/ops/onehot.py).

Every index domain of the engine is small and static (log window W, peer
slots V <= 8, entries per message E, inflight ring F, read slots R), so
indexed access is written as `idx == iota` masks and reductions, exactly
as the JAX package writes it. Keeping the same formulation keeps the edge
cases the same: an out-of-range index reads 0 and writes nothing, and ties
resolve to the first position.
"""

from __future__ import annotations

import functools

import torch

I32 = torch.int32


@functools.cache
def iota(size: int, device: torch.device) -> torch.Tensor:
    """[size] int32 arange, made once per (size, device); never written."""
    return torch.arange(size, dtype=I32, device=device)


def onehot(idx, size: int):
    """[...] int -> [..., size] bool, True where last-dim position == idx."""
    return idx.unsqueeze(-1) == iota(size, idx.device)


def argmax_last(x):
    """Index of the first maximum along the (small) last axis, int32."""
    if x.dtype == torch.bool:
        x = x.to(I32)
    best_v = x[..., 0]
    best_i = torch.zeros(x.shape[:-1], dtype=I32, device=x.device)
    for j in range(1, x.shape[-1]):
        better = x[..., j] > best_v
        best_v = torch.where(better, x[..., j], best_v)
        best_i = torch.where(better, j, best_i)
    return best_i


def cumsum_last(x):
    """Inclusive cumulative sum over the (small) last axis as an unrolled
    add chain (PyTorch's scan kernel is slow on a tiny innermost axis)."""
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def _expand_col(col, idx_ndim: int, w: int):
    """col [B..., W] -> [B..., 1 x extra, W] so it broadcasts against a
    one-hot of an index with extra trailing dims."""
    extra = idx_ndim + 1 - col.dim()
    return col.reshape(col.shape[:-1] + (1,) * extra + (w,))


def gather(col, idx):
    """col [B..., W] indexed along its last axis by idx [B..., K...] ->
    idx's shape; extra idx dims broadcast. Out-of-range indexes read 0."""
    w = col.shape[-1]
    if col.dtype == torch.bool:
        return gather(col.to(I32), idx).to(torch.bool)
    oh = onehot(idx, w)
    c = _expand_col(col, idx.dim(), w)
    return torch.where(oh, c, 0).sum(dim=-1, dtype=col.dtype)


def scatter_set(col, idx, vals, mask):
    """Masked one-hot scatter: col[..., idx[..., k]] = vals[..., k] where
    mask[..., k]; out-of-range idx drops. col [..., W]; idx/vals/mask
    [..., K]. Never an indexed write, so duplicate indexes are resolved by
    arithmetic (their sum) and not by a race; callers keep them distinct."""
    w = col.shape[-1]
    oh = onehot(idx, w) & mask.unsqueeze(-1)  # [..., K, W]
    hit = oh.any(dim=-2)
    val = torch.where(oh, vals.unsqueeze(-1), 0).sum(dim=-2, dtype=col.dtype)
    return torch.where(hit, val, col)


def _rolled(oh0, e: int):
    return [oh0 if k == 0 else torch.roll(oh0, k, dims=-1) for k in range(e)]


def gather_range(col, start, e: int):
    """Contiguous circular gather: out[..., k] = col[..., (start+k) mod W]."""
    return gather_range_multi([col], start, e)[0]


def gather_range_multi(cols, start, e: int):
    """gather_range over several same-shape columns at the SAME start,
    sharing one set of rolled one-hot masks."""
    w = cols[0].shape[-1]
    rolled = _rolled(onehot(start % w, w), e)
    outs = []
    for col in cols:
        as_bool = col.dtype == torch.bool
        if as_bool:
            col = col.to(I32)
        c = _expand_col(col, start.dim(), w)
        out = torch.stack(
            [torch.where(r, c, 0).sum(dim=-1, dtype=col.dtype) for r in rolled],
            dim=-1,
        )
        outs.append(out.to(torch.bool) if as_bool else out)
    return outs


def scatter_range_set_multi(cols, start, vals_list, mask):
    """Contiguous circular scatter over several same-shape columns at the
    SAME start/mask: col[..., (start+k) mod W] = vals[..., k] where
    mask[..., k]."""
    w = cols[0].shape[-1]
    k_count = vals_list[0].shape[-1]
    ohks = [
        r & mask[..., k : k + 1]
        for k, r in enumerate(_rolled(onehot(start % w, w), k_count))
    ]
    outs = []
    for col, vals in zip(cols, vals_list):
        hit = torch.zeros(col.shape, dtype=torch.bool, device=col.device)
        acc = torch.zeros_like(col)
        for k, ohk in enumerate(ohks):
            hit = hit | ohk
            acc = torch.where(ohk, vals[..., k : k + 1], acc)
        outs.append(torch.where(hit, acc, col))
    return outs


def sort_last(x, valid=None, pad=-1):
    """Ascending sort along the (small) last axis via an odd-even
    transposition network of elementwise min/max — no sort call. Invalid
    slots are replaced by `pad` first."""
    v = x.shape[-1]
    if valid is not None:
        x = torch.where(valid, x, pad)
    cols = [x[..., j] for j in range(v)]
    for rnd in range(v):
        for j in range(rnd & 1, v - 1, 2):
            lo = torch.minimum(cols[j], cols[j + 1])
            hi = torch.maximum(cols[j], cols[j + 1])
            cols[j], cols[j + 1] = lo, hi
    return torch.stack(cols, dim=-1)


def select_kth(sorted_x, k):
    """sorted_x [..., V], k [...] -> element at position k (clipped)."""
    v = sorted_x.shape[-1]
    return gather(sorted_x, torch.clamp(k, 0, v - 1))
