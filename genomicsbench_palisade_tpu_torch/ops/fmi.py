"""FM-index SMEM seeding as torch ops on an explicit device (bwa-mem2 semantics).

Port of genomicsbench_palisade_tpu/ops/fmi.py:56-589, the lockstep engine.
The reference walks each read's SMEM search with pointer-chasing occ
lookups (FMI_search.cpp:986-1326); here a batch of reads advances in
lockstep, each step gathering occ rows for every lane and counting bits.

The index is a dict of tensors on one device (`convert.fmi_index_from_numpy`):
`cp_occ` int64 [blocks, 8], the reference's CP_OCC record (counts of A, C,
G, T before the block, then the four one-hot words of the block's 64 BWT
positions, bit 63 - i for position i), `count` int64 [5] and
`sentinel_index` (an int).  An occ lookup is one row gather and a popcount
of the word masked to the positions before pp.  k, l and s are int64
throughout (the JAX package uses the index's dtype: the values are equal).

Reformulations, all bit-equal to the oracle (ops/oracle/fmi.py) and to
the JAX package's engine:
  * backwardExt of [B] intervals = one gather of the occ rows of k and k+s,
    the l updates as a reverse running sum, the sentinel offset
    (:1536-1565).
  * getSMEMsOnePos's prev array lives in fixed slots with validity masks;
    the extended sizes are monotone along it, so the reference's
    "s != curr_s" dedup is `new_s > exclusive running max of kept s`.
  * Pushes and emits are written as step-indexed trace rows ([steps, B],
    a row a step) and compacted once after each loop (`_compact_trace`).
  * getSMEMsAllPos's do-while read compaction becomes masked restarts.

The JAX `while_loop`s become Python loops whose condition is one
`bool(run.any())` a step: that is the only host synchronisation inside a
loop, and `stats` counts the steps (= syncs) and the occ rows gathered.

Not ported: the three-plane occ route without packed rows (every index the
port builds carries `cp_occ`) and the `ShardAxis` psum route of a
block-sharded index (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import torch

NEG = -(1 << 30)
_TOP_BIT = -(1 << 63)
# SWAR popcount constants (each below 2**63, so they are int64 scalars)
_M1, _M2, _M4, _H01 = (0x5555555555555555, 0x3333333333333333,
                       0x0F0F0F0F0F0F0F0F, 0x0101010101010101)


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 word.  `>>` is arithmetic on int64, so every
    shift is masked before use; the final multiply wraps, and its top byte,
    the count (at most 64), keeps the sign bit clear."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (x * _H01) >> 56


def top_mask(y: torch.Tensor) -> torch.Tensor:
    """The word with its top y bits set (y in 0..63; 0 for y == 0).  Shifting
    the top bit right arithmetically by y - 1 copies it y - 1 times; nothing
    is ever shifted by 64."""
    return torch.where(y > 0, _TOP_BIT >> (y - 1).clamp(min=0), 0)


def occ_all(index, pp, stats=None):
    """occ(pp, c) for all four bases: pp [...] int64 -> [..., 4] (GET_OCC,
    FMI_search.h:81-89): one cp_occ row a position."""
    row = index["cp_occ"][pp >> 6]  # [..., 8]
    if stats is not None:
        stats["occ_rows"] = stats.get("occ_rows", 0) + pp.numel()
    mask = top_mask(pp & 63)[..., None]
    return row[..., :4] + popcount64(row[..., 4:] & mask)


def backward_ext(index, k, l, s, a, stats=None):
    """Batched backwardExt: (k, l, s, a) [...] -> new (k, l, s).  The occ
    rows of k and k + s come from one gather."""
    occ_sp, occ_ep = occ_all(index, torch.stack([k, k + s]), stats)
    sentinel = index["sentinel_index"]
    k4 = index["count"][:4] + occ_sp
    s4 = occ_ep - occ_sp
    off = ((k <= sentinel) & (k + s > sentinel)).to(k4.dtype)
    # l[3]=l+off; l[2]=l[3]+s[3]; l[1]=l[2]+s[2]; l[0]=l[1]+s[1]
    l3 = l + off
    l2 = l3 + s4[..., 3]
    l1 = l2 + s4[..., 2]
    l0 = l1 + s4[..., 1]
    l4 = torch.stack([l0, l1, l2, l3], dim=-1)
    a_idx = a.expand(k.shape)[..., None]
    return (k4.gather(-1, a_idx)[..., 0], l4.gather(-1, a_idx)[..., 0],
            s4.gather(-1, a_idx)[..., 0])


def forward_ext(index, k, l, s, a, stats=None):
    """Forward extension = backward on the revcomp (swap k/l, base 3-a)."""
    k2, l2, s2 = backward_ext(index, l, k, s, 3 - a, stats)
    return l2, k2, s2


def _root_interval(index, a):
    count = index["count"]
    return count[a], count[3 - a], count[a + 1] - count[a]


def _at(enc, j):
    """enc[lane, j[lane]], j clamped into the row."""
    return enc.gather(1, j.clamp(0, enc.shape[1] - 1)[:, None])[:, 0]


def _emit(bufs, counts, mask, m, n, k, l, s, m_cap):
    """Write (m,n,k,l,s) at slot counts[lane] (the last slot once full) where
    mask; returns bufs (updated in place) and the new counts."""
    lane = torch.arange(counts.shape[0], device=counts.device)
    slot = counts.clamp(max=m_cap - 1)
    for key, val in zip("mnkls", (m, n, k, l, s)):
        buf = bufs[key]
        buf[lane, slot] = torch.where(mask, val, buf[lane, slot])
    return bufs, counts + mask.to(counts.dtype)


def _compact_trace(flags, rows, cap):
    """flags [T, B] bool; rows: dict of [T, B].  Returns (dict of [B, cap]
    in step order, counts [B]): a stable sort along the steps brings each
    lane's pushes to the front, and the first cap are kept.

    Truncation policy on overflow (count > cap): the FIRST cap pushes in
    step order are kept (the reference has no cap); the caller's overflow
    flag marks such lanes."""
    t = flags.shape[0]
    if t < cap:  # trace shorter than the slot buffer: pad with non-pushes
        flags_p = torch.nn.functional.pad(flags, (0, 0, 0, cap - t))
        rows = {k: torch.nn.functional.pad(v, (0, 0, 0, cap - t)) for k, v in rows.items()}
    else:
        flags_p = flags
    order = torch.argsort((~flags_p).to(torch.uint8), dim=0, stable=True)[:cap]  # [cap, B]
    out = {key: arr.gather(0, order).T for key, arr in rows.items()}
    return out, flags.sum(0)


def _new_match_bufs(b, cols, device):
    return {key: torch.zeros((b, cols), dtype=torch.int64, device=device) for key in "mnkls"}


def _count(stats, key, n=1):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def smems_one_pos_batch(index, enc, readlen, x0, min_intv, min_seed_len, m_cap=64, p_cap=48,
                        max_l=None, stats=None, step_key="steps"):
    """Batched getSMEMsOnePosOneThread (one starting position per lane).

    enc: [B, L] int64 base codes; readlen, x0, min_intv: [B] int64.
    Returns (match bufs dict [B, m_cap], counts [B], next_x [B], overflow [B]).
    `stats[step_key]` counts the loop steps.
    """
    b, l_max = enc.shape
    dev = enc.device
    if max_l is None:
        max_l = l_max
    a0 = _at(enc, x0)
    lane_ok = (a0 < 4) & (x0 < readlen)
    k, l, s = _root_interval(index, a0.clamp(0, 3))

    # ---------------- forward sweep ----------------
    # the current smem (m = x0, n, k, l, s); the pushes as step-indexed rows
    n = x0
    j = x0 + 1
    run = lane_ok & (x0 + 1 < readlen)
    nx = x0 + 1
    tpush = torch.zeros((max_l, b), dtype=torch.bool, device=dev)
    tn, tk, tl, ts = (torch.zeros((max_l, b), dtype=torch.int64, device=dev) for _ in range(4))
    t = 0
    while bool(run.any()):
        _count(stats, step_key)
        aj = _at(enc, j)
        run_in = run
        run = run & (j < readlen)
        valid_a = aj < 4
        do = run & valid_a
        nk, nl, ns = forward_ext(index, k, l, s, aj.clamp(0, 3), stats)
        # push the old smem when s differs (pre-break push, :1060-1066)
        tpush[t] = do & (ns != s)
        tn[t], tk[t], tl[t], ts[t] = n, k, l, s
        below = ns < min_intv
        adopt = do & ~below
        k = torch.where(adopt, nk, k)
        l = torch.where(adopt, nl, l)
        s = torch.where(adopt, ns, s)
        n = torch.where(adopt, j, n)
        # next_x: j+1 normally; j when breaking on s < min_intv
        brk_s = do & below
        brk_a = run & ~valid_a  # N base: break, next_x stays j+1
        nx = torch.where(run_in, torch.where(brk_s, j, j + 1), nx)
        run = run & ~brk_s & ~brk_a & (j + 1 < readlen)
        j = j + 1
        t += 1
    tm = torch.zeros((max_l, b), dtype=torch.int64, device=dev)
    tm[:t] = x0  # m never moves in the forward sweep: its rows in one write
    fwd, cnt = _compact_trace(tpush, dict(m=tm, n=tn, k=tk, l=tl, s=ts), p_cap)
    overflow = cnt > p_cap
    cnt = cnt.clamp(max=p_cap)

    # final push: if smem.s >= min_intv (:1085-1090); may duplicate the
    # pre-break push, exactly like the reference
    push = lane_ok & (s >= min_intv)
    fwd, cnt = _emit(fwd, cnt, push, x0, n, k, l, s, p_cap)
    overflow = overflow | (cnt > p_cap)
    cnt = cnt.clamp(max=p_cap)
    next_x = torch.where(lane_ok, nx, x0 + 1)

    # reverse the prev array (prevArray in-place reversal, :1092-1100)
    p_iota = torch.arange(p_cap, device=dev)[None, :]
    rev_idx = (cnt[:, None] - 1 - p_iota).clamp(0, p_cap - 1)
    pm, pn, pk, pl, ps = (fwd[key].gather(1, rev_idx) for key in "mnkls")
    pvalid = p_iota < cnt[:, None]

    # ---------------- backward sweep ----------------
    j = x0 - 1
    run = lane_ok & (x0 - 1 >= 0) & (cnt > 0)
    temit = torch.zeros((max_l, b), dtype=torch.bool, device=dev)
    em, en, ek, el, es = (torch.zeros((max_l, b), dtype=torch.int64, device=dev)
                          for _ in range(5))
    min_intv2 = min_intv[:, None]
    neg_col = torch.full((b, 1), NEG, dtype=torch.int64, device=dev)
    t = 0
    while bool(run.any()):
        _count(stats, step_key)
        run = run & (j >= 0)
        aj = _at(enc, j)
        do = run & (aj <= 3)
        nk, nl, ns = backward_ext(index, pk, pl, ps, aj.clamp(0, 3)[:, None], stats)
        plen = pn - pm + 1
        c1 = pvalid & (ns < min_intv2) & (plen >= min_seed_len)
        c2 = pvalid & (ns >= min_intv2)
        p0 = torch.where(c1 | c2, p_iota, p_cap).amin(1)  # [B]
        is_p0 = p_iota == p0[:, None]
        temit[t] = do & (p0 < p_cap) & (c1 & is_p0).any(1)
        # emit prev[p0] (the un-extended smem) as a step-trace row
        p0c = p0.clamp(0, p_cap - 1)[:, None]
        em[t], en[t], ek[t], el[t], es[t] = (v.gather(1, p0c)[:, 0] for v in (pm, pn, pk, pl, ps))
        # keep rule: c2 entries whose new s strictly exceeds the running
        # max of previously kept s (exclusive cummax over c2 entries)
        cm = torch.cummax(torch.where(c2, ns, NEG), dim=1).values
        kept = c2 & (ns > torch.cat([neg_col, cm[:, :-1]], dim=1))
        upd = do[:, None] & kept
        pk = torch.where(upd, nk, pk)
        pl = torch.where(upd, nl, pl)
        ps = torch.where(upd, ns, ps)
        pm = torch.where(upd, j[:, None], pm)
        pvalid = torch.where(do[:, None], kept, pvalid)
        # lanes that stop here (a > 3 or no valid slot) keep their state
        run = run & (aj <= 3) & pvalid.any(1) & (j - 1 >= 0)
        j = j - 1
        t += 1
    bufs, counts = _compact_trace(temit, dict(m=em, n=en, k=ek, l=el, s=es), m_cap)
    overflow = overflow | (counts > m_cap)
    counts = counts.clamp(max=m_cap)

    # final append: first valid slot, if long enough (:1167-1177)
    p0c = torch.where(pvalid, p_iota, p_cap).amin(1)
    has = (p0c < p_cap) & lane_ok
    p0c = p0c.clamp(0, p_cap - 1)[:, None]
    fm, fn, fk, fl, fs = (v.gather(1, p0c)[:, 0] for v in (pm, pn, pk, pl, ps))
    emit = has & ((fn - fm + 1) >= min_seed_len)
    bufs, counts = _emit(bufs, counts, emit, fm, fn, fk, fl, fs, m_cap)
    overflow = overflow | (emit & (counts > m_cap))
    return bufs, counts.clamp(max=m_cap), next_x, overflow


def smems_all_pos_batch(index, enc, readlen, min_intv, min_seed_len, m_cap=96, p_cap=48,
                        stats=None, step_key="steps"):
    """Batched getSMEMsAllPos: restart one-pos searches until reads exhaust.
    Returns (bufs dict [B, m_cap], counts [B], overflow [B])."""
    b, _ = enc.shape
    dev = enc.device
    # one dummy column past m_cap takes the masked and overflowing writes
    bufs = _new_match_bufs(b, m_cap + 1, dev)
    counts = torch.zeros(b, dtype=torch.int64, device=dev)
    ovf = torch.zeros(b, dtype=torch.bool, device=dev)
    x = torch.zeros(b, dtype=torch.int64, device=dev)
    p = torch.arange(m_cap, device=dev)[None, :]
    lane2 = torch.arange(b, device=dev)[:, None].expand(b, m_cap)
    while bool((act := x < readlen).any()):
        _count(stats, step_key)
        sub_bufs, sub_counts, next_x, sub_ovf = smems_one_pos_batch(
            index, enc, readlen, torch.minimum(x, readlen), min_intv, min_seed_len,
            m_cap=m_cap, p_cap=p_cap, stats=stats, step_key=step_key)
        # merge: append at counts..counts+sub_counts, one masked scatter a
        # buffer; masked-out and overflowing elements go to the dummy column
        # (the only repeated destination), so every live slot is written once
        take = act[:, None] & (p < sub_counts[:, None])
        raw = counts[:, None] + p
        dest = torch.where(take & (raw < m_cap), raw, m_cap)
        for key in "mnkls":
            bufs[key][lane2, dest] = sub_bufs[key]
        gcounts = counts + take.sum(1)
        ovf = ovf | (act & sub_ovf) | (gcounts > m_cap)
        # next_x always advances (next_x >= x+1, or == j > x)
        x = torch.maximum(torch.where(act, next_x, x), x + act.to(x.dtype))
        counts = gcounts.clamp(max=m_cap)
    return {key: v[:, :m_cap] for key, v in bufs.items()}, counts, ovf


def bwt_seed_strategy_batch(index, enc, readlen, max_intv, min_seed_len, m_cap=64, stats=None,
                            step_key="steps"):
    """Batched bwtSeedStrategyAllPos (LAST strategy, forward-only).
    Returns (bufs dict [B, m_cap], counts [B], overflow [B])."""
    b, _ = enc.shape
    dev = enc.device
    bufs = _new_match_bufs(b, m_cap, dev)
    counts = torch.zeros(b, dtype=torch.int64, device=dev)
    ovf = torch.zeros(b, dtype=torch.bool, device=dev)
    z = torch.zeros(b, dtype=torch.int64, device=dev)
    x, j, m, n, k, l, s = z, z, z, z, z, z, z
    rooted = torch.zeros(b, dtype=torch.bool, device=dev)
    # a per-lane state machine: each step either roots a new start position
    # or performs one forward-extension step
    while bool((act := x < readlen).any()):
        _count(stats, step_key)
        # --- rooting step (lanes not currently extending) ---
        want_root = act & ~rooted
        ax = _at(enc, x)
        root_ok = want_root & (ax < 4)
        k0, l0, s0 = _root_interval(index, ax.clamp(0, 3))
        k = torch.where(root_ok, k0, k)
        l = torch.where(root_ok, l0, l)
        s = torch.where(root_ok, s0, s)
        m = torch.where(root_ok, x, m)
        n = torch.where(root_ok, x, n)
        j = torch.where(root_ok, x + 1, j)
        # N at the start position: consume it (next_x = x+1)
        x_new = torch.where(want_root & (ax >= 4), x + 1, x)
        rooted = rooted | root_ok

        # --- one extension step (lanes already rooted; just-rooted lanes
        # extend next step) ---
        ext = act & rooted & ~want_root
        scan_end = ext & (j >= readlen)  # inner loop exhausted: x := j
        run = ext & (j < readlen)
        aj = _at(enc, j)
        good = run & (aj < 4)
        nk, nl, ns = forward_ext(index, k, l, s, aj.clamp(0, 3), stats)
        k = torch.where(good, nk, k)
        l = torch.where(good, nl, l)
        s = torch.where(good, ns, s)
        n = torch.where(good, j, n)
        hit = good & (s < max_intv) & ((n - m + 1) >= min_seed_len)
        emit = hit & (s > 0)
        ovf = ovf | (emit & (counts >= m_cap))
        bufs, counts = _emit(bufs, counts, emit, m, n, k, l, s, m_cap)

        brk = (run & (aj >= 4)) | hit  # restart at j+1
        x_new = torch.where(brk, j + 1, x_new)
        x = torch.where(scan_end, j, x_new)
        rooted = rooted & ~brk & ~scan_end
        j = torch.where(run & ~brk, j + 1, j)
    return bufs, counts, ovf
