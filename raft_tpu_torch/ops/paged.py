"""The paged entry log (raft_tpu/ops/paged.py): ragged log depth without
max-W lanes.

A flat `[N, W]` log window charges every lane W entries whether it holds
one entry or a full pipeline. Under paging each lane keeps a resident tail
of W_res entries in the carry, and the colder middle `(snap, last - W_res]`
lives in a shared pool of pages addressed through a per-lane page table:

    pt         [N, M]   uint16 page ids; 0 = unmapped (page 0 of every
                        allocation segment is a trash row)
    pool_term  [P, PE]  the carry's log_term dtype (uint16 under diet-v2)
    pool_type  [P, PE]  the carry's log_type dtype
    pool_bytes [P, PE]  the carry's log_bytes dtype
    faults     [N]      int32, pages gathered at page_in, cumulative
    exhausted  [N]      int32, page_out clamp events, cumulative
    dirty      [N]      int32, pages the allocator wrote, cumulative
    skipped    [N]      int32, allocator passes page_out_cond elided

Entry i belongs to page key `i >> log2(PE)`, kept in table slot
`key & (M - 1)`; a lane's paged keys are contiguous and at most kmax, and
M = next_pow2(kmax), so the slots are distinct.

`page_in` rebuilds the full window (zeros outside `(snap, last]`, the
canonical scrubbed layout), the rounds run on it unchanged, and `page_out`
splits it again with a from-scratch allocator: `need` pages per lane, ids
by an exclusive scan of `need` from 1, the pool rebuilt with every row no
live page writes zeroed. A lane that does not fit keeps its tail, drops
its overflow pages (they read back as absent entries), and gets
ERR_PAGE_EXHAUSTED and an `exhausted` bump: never a silent wrap.

Page ids are local to the sub-pool the allocator saw. With `segs`
allocation segments (the pallas engine's tiles under in-kernel paging)
the lanes split into `segs` equal runs and the pool into `segs` equal
sub-pools, each with its own trash row and its own scan; the functions
below take `segs` and work on a `[segs, N / segs, ...]` view. Values are
the same at every segmentation (page_out . page_in is the identity on a
scrubbed window); only the page ids and the counters' cadence differ.

Index math runs in int32 whatever the carry's dtypes. PyTorch has no
`where`, comparison or gather for uint16 on the card, so a uint16 column
moves as the int16 view of its bits. No environment variable is read: the
geometry comes from the Shape (its zero fields take JAX's defaults).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from raft_tpu_torch.config import Shape
from raft_tpu_torch.state import ERR_PAGE_EXHAUSTED, RaftState

I32 = torch.int32


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class PagePlan:
    """The resolved paged-log geometry (host-side, static)."""

    w: int  # full log window (Shape.log_window)
    w_res: int  # resident entries per lane
    pe: int  # entries per page
    m: int  # page-table slots per lane (next_pow2(kmax))
    pool_pages: int  # pool rows, the trash row(s) included

    @property
    def kmax(self) -> int:
        """The most pages one lane can need: `(snap, lo_res]` spans at most
        w - w_res indexes, which touch at most ceil((w - w_res) / pe) + 1
        page keys."""
        return -((self.w - self.w_res) // -self.pe) + 1


def validate_page_plan(shape: Shape, n_lanes: int) -> PagePlan:
    """The PagePlan of a Shape for n_lanes lanes, raising ValueError on a bad
    geometry with the JAX package's messages. A zero field takes JAX's
    default: W_res = min(8, W/2), PE = min(4, W_res), and a pool that
    provisions every lane fully (n * kmax + 8 pages)."""
    w = shape.log_window
    if w < 4:
        raise ValueError("paged entry log needs log_window >= 4 "
                         "(page_window must be a strict subset of it)")
    w_res = shape.page_window or min(8, w // 2)
    if w_res & (w_res - 1) or not 2 <= w_res < w:
        raise ValueError(
            f"page_window={w_res} must be a power of two in 2..log_window/2 "
            f"(log_window={w})"
        )
    pe = shape.page_entries or min(4, w_res)
    if pe & (pe - 1) or not 1 <= pe <= w:
        raise ValueError(
            f"page_entries={pe} must be a power of two in 1..log_window "
            f"(log_window={w})"
        )
    kmax = PagePlan(w=w, w_res=w_res, pe=pe, m=0, pool_pages=0).kmax
    pool = shape.pool_pages or n_lanes * kmax + 8
    if pool < kmax + 1:
        raise ValueError(
            f"pool_pages={pool} too small: must hold at least one lane's "
            f"full page set plus the trash row (kmax+1 = {kmax + 1} for "
            f"log_window={w}, page_window={w_res}, page_entries={pe})"
        )
    if pool > 1 << 16:
        raise ValueError(
            f"pool_pages={pool} must be <= 65536 (page ids are uint16 with "
            "page 0 reserved as the trash row)"
        )
    return PagePlan(w=w, w_res=w_res, pe=pe, m=_next_pow2(kmax), pool_pages=pool)


def check_pool_segments(plan: PagePlan, segs: int) -> None:
    """The pool must split evenly into `segs` sub-pools (one per allocation
    segment), each holding one lane's full page set plus its trash row."""
    if segs <= 1:
        return
    if plan.pool_pages % segs:
        raise ValueError(
            f"pool_pages={plan.pool_pages} must divide evenly into "
            f"{segs} allocation segments (one sub-pool per kernel tile "
            "per shard); pin Shape.pool_pages / RAFT_TPU_POOL_PAGES to "
            "a multiple"
        )
    if plan.pool_pages // segs < plan.kmax + 1:
        raise ValueError(
            f"pool_pages={plan.pool_pages} over {segs} allocation "
            f"segments leaves {plan.pool_pages // segs} pages per "
            f"segment; each needs at least kmax+1 = {plan.kmax + 1} "
            "(one lane's page set plus the segment's trash row)"
        )


_STATIC = {"static": True}


@dataclasses.dataclass(frozen=True)
class PagedLog:
    """The sidecar of a paged carry; its tensor leaves in the JAX package's
    order, the geometry (w, w_res) static (interop skips it)."""

    pt: Any
    pool_term: Any
    pool_type: Any
    pool_bytes: Any
    faults: Any
    exhausted: Any
    dirty: Any
    skipped: Any
    w: int = dataclasses.field(default=0, metadata=_STATIC)
    w_res: int = dataclasses.field(default=0, metadata=_STATIC)


LEAVES = ("pt", "pool_term", "pool_type", "pool_bytes",
          "faults", "exhausted", "dirty", "skipped")
LOG_COLS = ("log_term", "log_type", "log_bytes")
POOL_OF = dict(zip(LOG_COLS, ("pool_term", "pool_type", "pool_bytes")))


def init_paged(plan: PagePlan, state: RaftState) -> PagedLog:
    """An empty sidecar whose pool columns take `state`'s log dtypes."""
    n = state.last.shape[0]
    dev = state.last.device

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return PagedLog(
        pt=zeros((n, plan.m), torch.uint16),
        **{POOL_OF[c]: zeros((plan.pool_pages, plan.pe), getattr(state, c).dtype)
           for c in LOG_COLS},
        **{k: zeros((n,), I32) for k in ("faults", "exhausted", "dirty", "skipped")},
        w=plan.w,
        w_res=plan.w_res,
    )


# -- page_in / page_out on a [segs, N / segs, ...] view ----------------------


def _bits(x):
    """x as a dtype PyTorch gathers and selects on the card (uint16 -> the
    int16 view of the same bits)."""
    return x.view(torch.int16) if x.dtype == torch.uint16 else x


def _seg(x, segs: int):
    return x.reshape((segs, x.shape[0] // segs) + tuple(x.shape[1:]))


def _unseg(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _cursors(state: RaftState, segs: int):
    return _seg(state.last.to(I32), segs), _seg(state.snap_index.to(I32), segs)


def page_in(state: RaftState, paged: PagedLog, segs: int = 1):
    """The full `[N, W]` window from the resident tail and the pool; returns
    (full_state, paged) with `faults` bumped by the lane's mapped pages."""
    w, w_res = paged.w, paged.w_res
    p, pe = paged.pool_term.shape
    p //= segs
    m = paged.pt.shape[1]
    lpe = pe.bit_length() - 1
    dev = state.last.device
    last, snap = _cursors(state, segs)
    last, snap = last[..., None], snap[..., None]
    s = torch.arange(w, dtype=I32, device=dev)
    idx = last - ((last - s) & (w - 1))  # [S, n, W]
    valid = idx > snap
    lo_res = torch.maximum(snap, last - w_res)
    from_res = valid & (idx > lo_res)
    r_slot = (idx & (w_res - 1)).long()
    pt = _seg(paged.pt.to(I32), segs)  # [S, n, M]
    page = torch.gather(pt, 2, ((idx >> lpe) & (m - 1)).long())
    mapped = valid & ~from_res & (page > 0)
    ent = (torch.where(mapped, page, 0) * pe + (idx & (pe - 1))).long()
    segs_, n_seg = ent.shape[:2]

    def col(name):
        res = _bits(_seg(getattr(state, name), segs))
        pool = _bits(getattr(paged, POOL_OF[name])).reshape(segs, p * pe)
        rv = torch.gather(res, 2, r_slot)
        pv = torch.gather(pool, 1, ent.reshape(segs_, n_seg * w)).reshape(segs_, n_seg, w)
        z = torch.zeros((), dtype=res.dtype, device=dev)
        out = torch.where(from_res, rv, torch.where(mapped, pv, z))
        return _unseg(out).view(getattr(state, name).dtype)

    full = dataclasses.replace(state, **{c: col(c) for c in LOG_COLS})
    faults = paged.faults + (paged.pt.to(I32) > 0).sum(dim=1, dtype=I32)
    return full, dataclasses.replace(paged, faults=faults)


def _tail_cols(state: RaftState, paged: PagedLog) -> dict:
    """The resident `[N, W_res]` tail of a full window: entry i at slot
    i & (W_res - 1), zeros where it is not in `(lo_res, last]`."""
    w, w_res = paged.w, paged.w_res
    dev = state.last.device
    last = state.last.to(I32)[:, None]
    snap = state.snap_index.to(I32)[:, None]
    lo_res = torch.maximum(snap, last - w_res)
    r = torch.arange(w_res, dtype=I32, device=dev)
    i_r = last - ((last - r) & (w_res - 1))
    rvalid = i_r > lo_res
    rsl = (i_r & (w - 1)).long()
    out = {}
    for c in LOG_COLS:
        full = _bits(getattr(state, c))
        z = torch.zeros((), dtype=full.dtype, device=dev)
        out[c] = torch.where(rvalid, torch.gather(full, 1, rsl), z).view(getattr(state, c).dtype)
    return out


def page_out(state: RaftState, paged: PagedLog, segs: int = 1):
    """Split a full-window state into its resident tail and a pool and page
    table rebuilt from scratch; returns (resident_state, paged)."""
    w = paged.w
    p, pe = paged.pool_term.shape
    p //= segs
    m = paged.pt.shape[1]
    lpe = pe.bit_length() - 1
    dev = state.last.device
    last, snap = _cursors(state, segs)  # [S, n]
    lo_res = torch.maximum(snap, last - paged.w_res)

    # contiguous page ids by an exclusive scan of `need`, from 1 (page 0 is
    # the segment's trash row); a lane that runs out takes what is left
    k_lo = (snap + 1) >> lpe
    k_hi = lo_res >> lpe
    need = torch.where(lo_res > snap, k_hi - k_lo + 1, 0)
    page0 = 1 + torch.cumsum(need, dim=1, dtype=I32) - need
    n_alloc = torch.minimum(torch.clamp(p - page0, min=0), need)
    exh = n_alloc < need

    # slot mm holds key k_m = mm (mod M); keys [k_lo, k_lo + M) cover the
    # live range since need <= kmax <= M
    mm = torch.arange(m, dtype=I32, device=dev)
    k_m = k_lo[..., None] + ((mm - k_lo[..., None]) & (m - 1))  # [S, n, M]
    j = k_m - k_lo[..., None]
    live = j < n_alloc[..., None]
    pid = torch.where(live, page0[..., None] + j, 0)

    # row pid(k), column c holds entry k * PE + c where it is in
    # (snap, lo_res]; dead pages write zeros into the trash row
    ent = k_m[..., None] * pe + torch.arange(pe, dtype=I32, device=dev)  # [S, n, M, PE]
    pvalid = live[..., None] & (ent > snap[..., None, None]) & (ent <= lo_res[..., None, None])
    s_, n_seg = need.shape
    esl = (ent & (w - 1)).reshape(s_, n_seg, m * pe).long()
    rows = pid.reshape(s_, n_seg * m, 1).expand(s_, n_seg * m, pe).long()

    def pool_col(name):
        full = _bits(_seg(getattr(state, name), segs))
        z = torch.zeros((), dtype=full.dtype, device=dev)
        d = torch.where(pvalid, torch.gather(full, 2, esl).reshape(s_, n_seg, m, pe), z)
        pool = torch.zeros((s_, p, pe), dtype=full.dtype, device=dev)
        pool.scatter_(1, rows, d.reshape(s_, n_seg * m, pe))
        return pool.reshape(s_ * p, pe).view(getattr(state, name).dtype)

    exh = _unseg(exh)
    err = state.error_bits | torch.where(exh, ERR_PAGE_EXHAUSTED, 0).to(I32)
    resident = dataclasses.replace(state, error_bits=err, **_tail_cols(state, paged))
    new = dataclasses.replace(
        paged,
        pt=_unseg(pid).to(paged.pt.dtype),
        **{POOL_OF[c]: pool_col(c) for c in LOG_COLS},
        exhausted=paged.exhausted + exh.to(I32),
        dirty=paged.dirty + _unseg(n_alloc),
    )
    return resident, new


def page_out_cond(state: RaftState, paged: PagedLog, last_pre, snap_pre, *,
                  can_skip: bool, segs: int = 1):
    """page_out, or, where `can_skip` (every in-round log write lands in the
    resident window: E <= W_res) and no lane of a segment moved its `last`
    or `snap_index` since the page_in that took `last_pre` / `snap_pre`
    (int32), that segment's resident tail only, its table and pool kept
    and `skipped` bumped on its lanes. One device read decides: all
    segments moved, none, or a mix (then both are computed and selected
    per segment)."""
    if not can_skip:
        return page_out(state, paged, segs)
    moved = (_seg(state.last.to(I32) != last_pre, segs).any(dim=1)
             | _seg(state.snap_index.to(I32) != snap_pre, segs).any(dim=1))
    mv = moved.cpu()
    if bool(mv.all()):
        return page_out(state, paged, segs)
    skip_st = dataclasses.replace(state, **_tail_cols(state, paged))
    skip_pg = dataclasses.replace(paged, skipped=paged.skipped + 1)
    if not bool(mv.any()):
        return skip_st, skip_pg
    full_st, full_pg = page_out(state, paged, segs)

    def pick(a, b):
        sel = moved.reshape((segs,) + (1,) * a.dim())
        return _unseg(torch.where(sel, _bits(_seg(a, segs)), _bits(_seg(b, segs)))).view(a.dtype)

    st = dataclasses.replace(
        full_st, **{k: pick(getattr(full_st, k), getattr(skip_st, k))
                    for k in (*LOG_COLS, "error_bits")})
    pg = dataclasses.replace(
        full_pg, **{k: pick(getattr(full_pg, k), getattr(skip_pg, k)) for k in LEAVES})
    return st, pg


# -- host views of a paged carry -------------------------------------------------

# The JAX package's host twins are vmaps of page_in / page_out over the
# segments; here every function takes `segs` itself.
page_in_host = page_in
page_out_host = page_out


def page_in_view(state: RaftState, paged: PagedLog, segs: int = 1) -> RaftState:
    """The full-window view only (the faults bump is discarded)."""
    return page_in(state, paged, segs)[0]


def split_state(state: RaftState, plan: PagePlan, segs: int = 1):
    """A full-window state (in its storage form, slim or packed) split into
    (resident_state, paged) under a fresh sidecar."""
    return page_out(state, init_paged(plan, state), segs)


def resegment(state: RaftState, paged: PagedLog, old_segs: int, new_segs: int):
    """Re-key the pool and page table from one segmentation to another: read
    the full window under the old one, split it under the new."""
    if old_segs == new_segs:
        return state, paged
    return page_out(page_in_view(state, paged, old_segs), paged, new_segs)


def paged_stats(paged: PagedLog) -> dict:
    """Pool occupancy and the counters' sums (one device read)."""
    sums = torch.stack([
        (paged.pt.to(I32) > 0).sum(dtype=torch.int64),
        *(getattr(paged, k).sum(dtype=torch.int64)
          for k in ("faults", "exhausted", "dirty", "skipped")),
    ]).cpu().tolist()
    return {
        "paged_pool_in_use": sums[0],
        "paged_pool_pages": int(paged.pool_term.shape[0]),
        "paged_page_faults": sums[1],
        "paged_exhausted": sums[2],
        "paged_pages_dirty": sums[3],
        "paged_alloc_skipped": sums[4],
    }


def mapped_pages_per_lane(paged: PagedLog):
    """Mapped pages of each lane (numpy [N] int64)."""
    return (paged.pt.to(I32) > 0).sum(dim=1).cpu().numpy().astype("int64")


def paged_bytes_per_lane(paged: PagedLog) -> float:
    """Bytes per lane of the sidecar: page table, counters and the lane's
    share of the pool (the resident log columns are the carry's)."""
    n = paged.pt.shape[0]
    return sum(getattr(paged, k).numel() * getattr(paged, k).element_size()
               for k in LEAVES) / n
