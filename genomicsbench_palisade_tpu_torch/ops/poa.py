"""Partial-order alignment as torch ops (spoa's convex alignment).

The port of genomicsbench_palisade_tpu/ops/poa.py's device path.  The
graph mutates with every added sequence (pointer work: it stays on the
host, the port's `ops.oracle.poa.PoaGraph`); the O(nodes x width) convex
DP and its traceback run on the device for many MSA windows in lockstep:

  round k: align sequence k of EVERY window on the device,
           then apply the k-th graph updates on the host.

The DP is the JAX package's exact reformulation of spoa's
(sisd_alignment_engine.cpp:659-907), in int32 that wraps as the JAX
package's does:
  * F/O (vertical, graph-edge gaps) are max-reductions over a node's
    padded predecessor rows: one gather of [window, slot, 3, width] a row;
  * E/Q (horizontal gaps) couple through H within a row; each chain has
    the closed form E[j] = g + (j-1)e + max_{j'<j}(H[j'] - j'e) (a
    cummax), and H is iterated to its fixpoint.  The JAX package loops
    until H stops changing; the port runs a fixed number of passes a row
    on the device, keeps a device flag "changed on the last pass" and
    reads it once a round: if it is set, the round is filled again with
    twice the passes.  H is monotone in the passes, so the result is the
    JAX package's fixpoint;
  * the fill also writes the traceback's 13 decision planes a row (the
    reference's walk order: diagonal over predecessors, vertical with
    extend-up, horizontal with extend-left, and both repair loops'
    conditions), and the traceback is a walk of one (node rank, column)
    entry a step that reads one plane column.

The JAX package vmaps the single-window aligner; the port runs one
function over an explicit window axis.  Its TPU workaround, a ring of the
last 32 rows read by a one-hot sum in place of a slow gather
(`RING_D`), is not ported: a predecessor row is a plain gather here, and
the tests hold the port to both JAX paths.  On CUDA a row step and a block
of TB_BLOCK traceback steps are each one CUDA graph a batch shape, replayed
with the row and step counters in device memory.  Host syncs a round: the
fixpoint flag, one a traceback block (the walk stops once every window is
done), and the alignments' copy to the host.

Rank-space graph arrays (padded): code [N], preds [N, P] (rank+1, 0 = the
virtual start row), npreds [N], out_empty [N], n_nodes.  The JAX
package's native host engine stands beside the device aligner:
`NativePoaGraph` (native/poagraph.cpp and poaalign.cpp: spoa's graph and
its convex alignment in C++) and `msa_consensus_host` (a window's whole
loop in C++), which `cli.poa --engine host` runs; `auto` stays the device
aligner (ROADMAP queue 3).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from .. import default_device
from ..convert import poa_batch_from_numpy
from ..io import native
from .oracle.poa import PoaGraph, PoaParams, convex_align

NEG_INF = -(1 << 31) + 1024  # spoa kNegativeInfinity
NPLANES = 13
FIX_PASSES = 2  # E/Q passes a row in a round's first fill
FIX_MAX_PASSES = 4096
TB_BLOCK = 64  # traceback steps between two checks that every window is done
# bytes of fill state (13 planes + H, F, O as int32 a cell) a sub-batch may
# hold on the card: a window of 2,048 nodes x 1,024 columns takes 134 MB,
# so 119 such windows go in one sub-batch (the JAX package's 2 GB rule was
# for a 16 GB TPU)
DEVICE_BUDGET = 16_000_000_000
MODE_NORMAL, MODE_EL, MODE_EU = 0, 1, 2


_ACGT = {ch: i for i, ch in enumerate("ACGT")}  # sequence and graph codes on the device


def _i32(x: int) -> int:
    """x wrapped to int32, as a JAX int32 constant expression wraps."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def graph_to_arrays(graph, n_cap: int, p_cap: int, code_map=None):
    """Host: PoaGraph -> padded rank-space arrays. Returns None on overflow.

    Vectorized over the edge list.  `code_map` optionally translates
    per-graph codes to global ACGT codes in the same pass (others to 9).
    Pred slots keep the node.in_edges order (edges are appended to in_edges
    at creation, so stable-sorting by end rank preserves it)."""
    n = len(graph.nodes)
    if n > n_cap:
        return None
    code = np.zeros(n_cap, np.int32)
    preds = np.zeros((n_cap, p_cap), np.int32)
    npreds = np.zeros(n_cap, np.int32)
    out_empty = np.zeros(n_cap, bool)
    if n:
        r2n = np.asarray(graph.rank_to_node_id, np.int64)
        node_rank = np.empty(n, np.int64)
        node_rank[r2n] = np.arange(n)
        node_codes = np.fromiter((nd.code for nd in graph.nodes), np.int64, n)
        if code_map is None:
            code[:n] = node_codes[r2n]
        else:
            glob = np.array([code_map.get(ch, 9) for ch in graph.decoder], np.int64)
            code[:n] = glob[node_codes[r2n]]
        ne = len(graph.edges)
        out_empty[:n] = True
        if ne:
            eb = np.fromiter((ed.begin for ed in graph.edges), np.int64, ne)
            ee = np.fromiter((ed.end for ed in graph.edges), np.int64, ne)
            er = node_rank[ee]
            order = np.argsort(er, kind="stable")
            er_s = er[order]
            deg = np.bincount(er_s, minlength=n)
            if deg.max() > p_cap:
                return None
            starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
            slots = np.arange(ne) - starts[er_s]
            preds[er_s, slots] = node_rank[eb[order]] + 1
            npreds[:n] = deg
            out_empty[:n] = np.bincount(node_rank[eb], minlength=n) == 0
    return {"code": code, "preds": preds, "npreds": npreds, "out_empty": out_empty,
            "n_nodes": np.int32(n)}


def _first_index(x, dim: int):
    """Index of the first maximum along dim (spoa keeps the first maximum
    by a strict <): the least index whose value equals the max."""
    mx = x.amax(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    iota = torch.arange(x.shape[dim], device=x.device).view(shape)
    return torch.where(x == mx, iota, x.shape[dim]).amin(dim)


class _Aligner:
    """A batch shape's device state: the inputs, the packed H/F/O rows
    [B, N+1, 3, W], the planes [B, N+1, NPLANES, W], the walk's state and
    output, and on CUDA the captured graphs of a row step and of a block of
    traceback steps."""

    def __init__(self, b, n_cap, w_cap, p, a_cap, atype, params, passes, device):
        assert atype in ("nw", "sw", "ov"), atype
        self.b, self.n, self.w, self.p, self.a_cap = b, n_cap, w_cap, p, a_cap
        self.atype, self.passes, self.device = atype, passes, device
        self.params = tuple(_i32(x) for x in params)
        m, nmis, g, e, q, c = self.params
        i32, i64, dev = torch.int32, torch.int64, device

        def z(shape, dtype=i32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # inputs, copied in by run(); seq's column 0 is never read
        self.seq, self.seqlen = z((b, w_cap)), z(b)
        self.code, self.preds, self.npreds = z((b, n_cap)), z((b, n_cap, p), i64), z((b, n_cap))
        self.hfo = z((b, n_cap + 1, 3, w_cap))
        self.bits = z((b, n_cap + 1, NPLANES, w_cap))
        self.r = z(1, i64)  # the row step's row (rank), in device memory
        self.changed = z((), torch.bool)

        j = torch.arange(w_cap, dtype=i32, device=dev)
        self.jz = (j == 0)[None, :]
        self.p_iota = torch.arange(p, device=dev)[None, :]
        self.row_base = (torch.arange(b, device=dev) * (n_cap + 1))[:, None]
        self.neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
        self.m, self.nmis = (torch.tensor(x, dtype=i32, device=dev) for x in (m, nmis))
        self.neg_col = torch.full((b, p, 1), NEG_INF, dtype=i32, device=dev)
        self.neg_col1 = torch.full((b, 1), NEG_INF, dtype=i32, device=dev)
        self.zero_col1 = z((b, 1))
        # the gap chains' terms: j*ext and open + (j-1)*ext, int32 that wraps
        self.jx = {x: j * x for x in (e, c)}
        self.chain_add = {(o, x): o + (j - 1) * x for o, x in ((g, e), (q, c))}

        # row 0 (the virtual start) and its planes, as the JAX package's init
        neg = torch.full_like(j, NEG_INF)
        row0_o = torch.where(j == 0, 0, neg)
        row0_q = torch.where(j == 0, 0, q + (j - 1) * c)
        row0_f = row0_o
        row0_e = torch.where(j == 0, 0, g + (j - 1) * e)
        row0_h = (torch.zeros_like(j) if atype == "sw"
                  else torch.where(j == 0, 0, torch.maximum(row0_q, row0_e)))
        self.hfo[:, 0] = torch.stack([row0_h, row0_f, row0_o])

        def sh(v):
            return torch.cat([neg[:1], v[:-1]])

        def nx(v):
            return torch.cat([v[1:], torch.zeros_like(v[:1])])

        e1 = row0_h == sh(row0_e) + e
        e2 = row0_h == sh(row0_h) + g
        e3 = row0_h == sh(row0_q) + c
        e4 = row0_h == sh(row0_h) + q
        zero = torch.zeros_like(j, dtype=torch.bool)
        planes0 = [zero] * 5 + [(j != 0) & (e1 | e2 | e3 | e4), e1 | (~e2 & e3),
                                (row0_e + e != nx(row0_e)) & (row0_q + c != nx(row0_q))]
        planes0 += [zero] * 4 + [row0_h == 0]
        self.bits[:, 0] = torch.stack([x.to(i32) for x in planes0])

        # the walk's state, its output ([2, B, a_pad]: ranks, columns) and count
        self.a_pad = -(-a_cap // TB_BLOCK) * TB_BLOCK
        self.ti, self.tj, self.tmode = z(b), z(b), z(b)
        self.tdone = z(b, torch.bool)
        self.t = z(1, i64)
        self.out = z((2, b, self.a_pad))
        self.cnt = z(b)
        self.plane_off = (torch.arange(NPLANES, device=dev) * w_cap)[None, :]
        self.graphs = None

    # ---------------------------------------------------------------- fill
    def _chain(self, h, open_pen, ext_pen):
        """E[j] = open + (j-1)*ext + max_{j'<j}(h[j'] - j'*ext); E[0] = NEG_INF."""
        cm = torch.cummax(h - self.jx[ext_pen], 1).values
        e = torch.cat([self.neg_col1, cm[:, :-1]], 1) + self.chain_add[open_pen, ext_pen]
        return torch.where(self.jz, self.neg, e)

    def _row_step(self):
        """Row r = self.r of every window (node rank r, matrix row r+1):
        H/F/O and the planes, written in place; then r += 1."""
        b, n, w, p = self.b, self.n, self.w, self.p
        _, _, g, e, q, c = self.params
        r, jz, neg = self.r, self.jz, self.neg
        code_i = self.code.index_select(1, r)  # [B, 1]
        np_r = self.npreds.index_select(1, r)  # [B, 1]
        pred_mask = self.p_iota < np_r.clamp(min=1)  # [B, P]
        pm_eu = self.p_iota < np_r
        pred_idx = torch.where(pred_mask, self.preds.index_select(1, r)[:, 0], 0)
        hfo_p = self.hfo.view(b * (n + 1), 3 * w).index_select(
            0, (pred_idx + self.row_base).view(-1)).view(b, p, 3, w)
        h_p, f_p, o_p = hfo_p.unbind(2)  # [B, P, W]
        pm3 = pred_mask[:, :, None]
        h_pm = torch.where(pm3, h_p, neg)
        f_pm = torch.where(pm3, f_p, neg)
        o_pm = torch.where(pm3, o_p, neg)

        # column 0 (initialize(): the penalty from the preds, or q-c / g-e);
        # H there is set from the gap chains for nw only
        has_preds = np_r[:, 0] > 0
        f0 = torch.where(has_preds, torch.where(pred_mask, f_p[:, :, 0], neg).amax(1),
                         _i32(g - e)) + e
        o0 = torch.where(has_preds, torch.where(pred_mask, o_p[:, :, 0], neg).amax(1),
                         _i32(q - c)) + c
        h0 = (torch.maximum(f0, o0) if self.atype == "nw" else torch.zeros_like(f0))[:, None]

        f_row = torch.maximum(h_pm + g, f_pm + e).amax(1)
        o_row = torch.maximum(h_pm + q, o_pm + c).amax(1)
        prof = torch.where(jz, 0, torch.where(self.seq == code_i, self.m, self.nmis))  # [B, W]
        diag = torch.cat([self.neg_col, h_pm[:, :, :-1]], 2) + prof[:, None, :]
        base = torch.maximum(diag.amax(1), torch.maximum(f_row, o_row))
        if self.atype == "sw":
            base = base.clamp(min=0)
        base = torch.where(jz, h0, base)
        f_row = torch.where(jz, f0[:, None], f_row)
        o_row = torch.where(jz, o0[:, None], o_row)

        # the E/Q fixpoint: a fixed number of passes; the flag records a row
        # whose last pass still changed H
        h = base
        for t in range(self.passes):
            e_row = self._chain(h, g, e)
            q_row = self._chain(h, q, c)
            h_new = torch.maximum(base, torch.maximum(e_row, q_row))
            if self.atype == "sw":  # local: every cell clamped at 0 (:747-749)
                h_new = h_new.clamp(min=0)
            h_new = torch.where(jz, h0, h_new)
            if t == self.passes - 1:
                self.changed.logical_or_((h_new != h).any())
            h = h_new
        # unchanged on the last pass: e_row, q_row are the chains of the final H

        # the traceback's planes for this row
        hb = h[:, None, :]
        pi = pred_idx[:, :, None]

        def first(ok):  # [B, P, W] -> the first true slot of each column
            return ok & (torch.cumsum(ok, 1) == 1)

        def pick(first_mask):  # the pred index at the first true slot (0 if none)
            return torch.where(first_mask, pi, -1).amax(1).clamp(min=0)

        diag_ok = pm3 & (hb == diag) & ~jz[:, None, :]
        fe, hg, oc, hq = f_p + e, h_p + g, o_p + c, h_p + q
        c1, c2, c3 = pm3 & (hb == fe), pm3 & (hb == hg), pm3 & (hb == oc)
        vert_ok = c1 | c2 | c3 | (pm3 & (hb == hq))
        first_v = first(vert_ok)

        def sh(v):
            return torch.cat([self.neg_col1, v[:, :-1]], 1)

        def nx(v):
            return torch.cat([v[:, 1:], self.zero_col1], 1)

        sh_h = sh(h)
        e1, e2, e3 = h == sh(e_row) + e, h == sh_h + g, h == sh(q_row) + c
        e4 = h == sh_h + q
        pe3 = pm_eu[:, :, None]
        cond_a = pe3 & ((f_row[:, None, :] == fe) | (o_row[:, None, :] == oc))
        cond_b = pe3 & ((f_row[:, None, :] == hg) | (o_row[:, None, :] == hq))
        planes = [diag_ok.any(1), pick(first(diag_ok)),
                  vert_ok.any(1), pick(first_v), (first_v & (c1 | (~c2 & c3))).any(1),
                  ~jz & (e1 | e2 | e3 | e4), e1 | (~e2 & e3),
                  (e_row + e != nx(e_row)) & (q_row + c != nx(q_row)),
                  cond_a.any(1), pick(first(cond_a)), cond_b.any(1), pick(first(cond_b)),
                  h == 0]  # the sw traceback's stop bit
        i = r + 1
        self.hfo.view(b, n + 1, 3 * w).index_copy_(
            1, i, torch.stack([h, f_row, o_row], 1).view(b, 1, 3 * w))
        self.bits.view(b, n + 1, NPLANES * w).index_copy_(
            1, i, torch.stack([x.to(torch.int32) for x in planes], 1).view(b, 1, NPLANES * w))
        self.r.add_(1)

    # ----------------------------------------------------------- traceback
    def _walk_step(self):
        """One step of every window's walk (the reference's backtrack as a
        three-mode machine: normal, extend-left, extend-up): reads one plane
        column at (i, j), or (i, j-1) in extend-left, and writes one entry."""
        i, j, mode, done = self.ti, self.tj, self.tmode, self.tdone
        j_eff = torch.where(mode == MODE_EL, j - 1, j)
        # the JAX walk's dynamic_slice clamps its start into the planes
        row = i.clamp(0, self.n).to(torch.int64) + self.row_base[:, 0]
        col = j_eff.clamp(0, self.w - 1).to(torch.int64)
        v = torch.take(self.bits, (row * NPLANES)[:, None] * self.w + self.plane_off
                       + col[:, None]).unbind(1)

        if self.atype == "nw":
            at_end = (i == 0) & (j == 0)
        elif self.atype == "ov":
            at_end = (i == 0) | (j == 0)
        else:  # sw: stop where H[i][j] == 0 (plane 12)
            at_end = v[12] == 1
        fd = (v[0] == 1) & ~at_end
        fv = (v[2] == 1) & ~fd & ~at_end
        fh = (v[5] == 1) & ~fd & ~fv & ~at_end
        anyf = fd | fv | fh
        n_prev_i = torch.where(anyf, torch.where(fd, v[1], torch.where(fv, v[3], i)), 0)
        n_prev_j = torch.where(anyf, torch.where(fd | fh, j - 1, j), 0)
        n_oi = torch.where(i == n_prev_i, -1, i - 1)
        n_oj = torch.where(j == n_prev_j, -1, j - 1)
        n_mode = torch.where(fv & (v[4] == 1), MODE_EU,
                             torch.where(fh & (v[6] == 1), MODE_EL, MODE_NORMAL))
        el_more = v[7] == 0  # the stop bit at (i, j-1)
        eu_prev = torch.where(v[8] == 1, v[9], torch.where(v[10] == 1, v[11], 0))
        eu_more = (v[8] == 1) & (eu_prev != 0)

        is_n, is_el = mode == MODE_NORMAL, mode == MODE_EL
        oi = torch.where(is_n, n_oi, torch.where(is_el, -1, i - 1))
        oj = torch.where(is_n, n_oj, torch.where(is_el, j - 1, -1))
        i2 = torch.where(is_n, n_prev_i, torch.where(is_el, i, eu_prev))
        j2 = torch.where(is_n, n_prev_j, torch.where(is_el, j - 1, j))
        mode2 = torch.where(is_n, n_mode, torch.where(
            is_el, torch.where(el_more, MODE_EL, MODE_NORMAL),
            torch.where(eu_more, MODE_EU, MODE_NORMAL)))
        stop = is_n & at_end
        emit = ~done & ~stop
        done2 = done | stop
        self.out.index_copy_(2, self.t, torch.stack([torch.where(emit, oi, -2),
                                                     torch.where(emit, oj, -2)])[:, :, None])
        self.cnt.add_(emit.to(torch.int32))
        self.ti.copy_(torch.where(done2, i, i2))
        self.tj.copy_(torch.where(done2, j, j2))
        self.tmode.copy_(torch.where(done2, mode, mode2))
        self.tdone.copy_(done2)
        self.t.add_(1)

    def _walk_block(self):
        for _ in range(TB_BLOCK):
            self._walk_step()

    def _start(self, n_nodes, out_empty, rows: int):
        """The walk's start: the max cell of the filled rows (type-dependent
        cell set; the first maximum in rank-then-column order)."""
        b, dev = self.b, self.device
        h_last = self.hfo[:, 1 : rows + 1, 0, :]  # [B, R, W]: row i is rank i-1
        live = torch.arange(rows, device=dev)[None, :] < n_nodes[:, None]
        is_sink = out_empty[:, :rows] & live
        bi = torch.arange(b, device=dev)
        seqlen = self.seqlen.to(torch.int64)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        if self.atype == "nw":  # the last column of sink rows
            end = h_last.gather(2, seqlen[:, None, None].expand(b, rows, 1))[:, :, 0]
            best = _first_index(torch.where(is_sink, end, self.neg), 1)
            max_j = self.seqlen
        else:  # sw: all cells of live rows; ov: all cells of sink rows
            j = torch.arange(self.w, device=dev)[None, :]
            j_ok = (j >= 1) & (j <= seqlen[:, None])
            h_m = torch.where(j_ok[:, None, :], h_last, self.neg)
            row_arg = _first_index(h_m, 2)
            scores = torch.where(is_sink if self.atype == "ov" else live, h_m.amax(2), self.neg)
            best = _first_index(scores, 1)
            max_j = row_arg[bi, best].to(torch.int32)
            if self.atype == "sw":  # no positive cell: an empty alignment
                done = scores[bi, best] <= 0
        self.ti.copy_(best + 1)
        self.tj.copy_(max_j)
        self.tmode.zero_()
        self.tdone.copy_(done)
        self.t.zero_()
        self.cnt.zero_()
        self.out.fill_(-2)

    # ---------------------------------------------------------------- run
    def _capture(self):
        """On CUDA: one graph of a row step and one of a walk block, each
        after a warm-up on a side stream (its writes are overwritten)."""
        graphs = []
        for fn in (self._row_step, self._walk_block):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            graphs.append(graph)
        self.graphs = graphs

    def run(self, batch: dict, stats: dict):
        """Align the batch (convert.poa_batch_from_numpy's tensors, this
        shape's B and P).  Returns (ai, aj, cnt) as the JAX package's
        vmapped aligner gives them ([B, a_cap] ranks or -1, columns or -1,
        -2 past cnt), or None if some row's fixpoint needs more passes."""
        dev, b = self.device, self.b
        if dev.type == "cuda" and self.graphs is None:
            self._capture()
        row, block = ((self.graphs[0].replay, self.graphs[1].replay) if self.graphs
                      else (self._row_step, self._walk_block))
        self.seq[:, 1:].copy_(batch["seq"])
        self.seqlen.copy_(batch["seqlen"])
        for k in ("code", "preds", "npreds"):
            getattr(self, k).copy_(batch[k])
        rows = batch["rows"]  # rows past the largest graph are never read
        self.r.zero_()
        self.changed.zero_()
        t0 = time.perf_counter()
        for _ in range(rows):
            row()
        again = bool(self.changed)
        t1 = time.perf_counter()
        stats["fill_s"] = stats.get("fill_s", 0.0) + t1 - t0
        stats["fill_rows"] = stats.get("fill_rows", 0) + rows
        stats["syncs"] = stats.get("syncs", 0) + 1
        if again:
            return None
        self._start(batch["n_nodes"].to(torch.int64), batch["out_empty"], rows)
        steps = 0
        while steps < self.a_cap:
            block()
            steps += TB_BLOCK
            stats["syncs"] += 1
            if bool(self.tdone.all()):
                break
        host = torch.cat([self.out[:, :, : self.a_cap].reshape(-1), self.cnt]).cpu().numpy()
        ai, aj = host[:-b].reshape(2, b, self.a_cap)
        cnt = np.minimum(host[-b:], self.a_cap)
        stats["syncs"] += 1
        stats["tb_s"] = stats.get("tb_s", 0.0) + time.perf_counter() - t1
        stats["tb_steps"] = stats.get("tb_steps", 0) + steps
        return ai, aj, cnt


def poa_align_device(batch: dict, params, w_cap: int, a_cap: int, atype: str = "nw",
                     cache: dict | None = None, stats: dict | None = None):
    """Convex alignment of sequence b against graph b for every window b of
    a batch on its tensors' device (`convert.poa_batch_from_numpy`): the
    JAX package's vmapped poa_align_device, for all three spoa
    AlignmentTypes (alignment_engine.hpp:19-24):

      nw  H boundaries from the gap chains; max cell in the last column of
          sink rows; traceback to (0, 0).
      sw  zero H boundaries, every cell clamped at 0 (:747-749), max over
          all cells (first in rank-then-column order), traceback stops at
          H == 0.
      ov  NW top row / zero first column (:214-240), max over all cells of
          sink rows, traceback stops at i == 0 or j == 0.

    Returns numpy (aln_i [B, a_cap] rank-or-minus-one, aln_j [B, a_cap],
    aln_len [B]).  `cache` keeps the last batch shape's buffers and CUDA
    graphs for the next call, and the passes a row the last fill needed;
    `stats` takes the phases' times and counts."""
    stats = {} if stats is None else stats
    cache = {} if cache is None else cache
    b, n_cap, p = batch["preds"].shape
    dev = batch["preds"].device
    passes = max(cache.get("passes", FIX_PASSES), FIX_PASSES)
    while True:
        key = (b, n_cap, w_cap, p, a_cap, atype, tuple(params), passes, dev)
        if cache.get("key") != key:  # one shape's buffers and graphs at a time
            cache.pop("aligner", None)
            cache["aligner"] = _Aligner(b, n_cap, w_cap, p, a_cap, atype, params, passes, dev)
            cache["key"] = key
        out = cache["aligner"].run(batch, stats)
        stats["passes"] = max(stats.get("passes", 0), passes)
        if out is not None:
            cache["passes"] = passes
            return out
        stats["reruns"] = stats.get("reruns", 0) + 1
        passes *= 2
        if passes > FIX_MAX_PASSES:
            raise RuntimeError(f"the E/Q fixpoint did not converge in {FIX_MAX_PASSES // 2} "
                               "passes a row")


def round_caps(graphs, seqs):
    """(n_cap, w_cap, a_cap) of a lockstep round as the JAX package sizes
    them: powers of two of at least 8 over the most nodes and the longest
    sequence, and room for every node and base in an alignment."""
    n_cap = max(8, int(2 ** np.ceil(np.log2(max(len(g.nodes) for g in graphs) + 1))))
    w_cap = max(8, int(2 ** np.ceil(np.log2(max(len(s) for s in seqs) + 2))))
    return n_cap, w_cap, n_cap + w_cap + 4


def round_arrays(graphs, seqs, p_cap: int = 16):
    """A round's host arrays at `round_caps`: each graph in rank space
    (graph_to_arrays) and each sequence's ACGT codes (others 9).  Returns
    (garrs, seq_arr [B, w_cap - 1], seq_len [B], w_cap, a_cap); a graph
    with more than p_cap predecessors a node raises."""
    n_cap, w_cap, a_cap = round_caps(graphs, seqs)
    garrs = [graph_to_arrays(g, n_cap, p_cap, code_map=_ACGT) for g in graphs]
    if any(a is None for a in garrs):
        raise ValueError(f"a graph has more than {p_cap} predecessors a node")
    seq_arr = np.zeros((len(seqs), w_cap - 1), np.int32)
    seq_len = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        seq_arr[i, : len(s)] = [_ACGT.get(ch, 9) for ch in s]
        seq_len[i] = len(s)
    return garrs, seq_arr, seq_len, w_cap, a_cap


def align_batch(graphs, seqs, params=(2, -4, -6, -2, -25, -1), n_cap=None, p_cap=16,
                w_cap=None, a_cap=None, align_type: str = "nw", device=None,
                cache: dict | None = None, stats: dict | None = None):
    """Host entry: align seqs[k] against graphs[k] for every window k.

    graphs: list of PoaGraph; seqs: list of str (codes via ACGT->0..3,
    others 9).  align_type selects the spoa AlignmentType ("nw" — the
    benchmark driver's hardcoded choice, msa_spoa_omp.cpp:264 — "sw" or
    "ov").  Caps as the JAX package sizes them.  A graph over n_cap nodes
    or p_cap predecessors a node, and an empty graph, go to the oracle's
    convex_align on the host, as in the JAX package (with `params`; the
    JAX package passes the oracle's defaults, ROADMAP queue 3).  Returns a
    list of spoa Alignment lists [(node_id, seq_pos)].  `cache` and `stats`
    as poa_align_device; stats also takes "arrays_s" and "aligned" (windows aligned on the device)."""

    device = default_device(device)
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    code_map = _ACGT
    b = len(graphs)
    auto_n, auto_w, _ = round_caps(graphs, seqs)
    n_cap = auto_n if n_cap is None else n_cap
    w_cap = auto_w if w_cap is None else w_cap
    a_cap = n_cap + w_cap + 4 if a_cap is None else a_cap

    out = [None] * b
    on_device, garrs = [], []
    for gi, g in enumerate(graphs):
        arr = graph_to_arrays(g, n_cap, p_cap, code_map=code_map) if g.nodes else None
        if arr is None:
            out[gi] = convex_align(seqs[gi], g, PoaParams(*params), align_type=align_type)
        else:
            on_device.append(gi)
            garrs.append(arr)
    stats["arrays_s"] = stats.get("arrays_s", 0.0) + time.perf_counter() - t0
    if not on_device:
        return out
    seq_arr = np.zeros((len(on_device), w_cap - 1), np.int32)
    seq_len = np.zeros(len(on_device), np.int32)
    for k, gi in enumerate(on_device):
        codes = [code_map.get(ch, 9) for ch in seqs[gi]]
        seq_arr[k, : len(codes)] = codes
        seq_len[k] = len(codes)
    # predecessor slots: the batch's widest in-degree rounded up to a power
    # of two (fewer shapes to capture; masked slots change no output)
    deg = max(1, max(int(a["npreds"].max()) for a in garrs))
    p_slots = min(p_cap, 1 << (deg - 1).bit_length())
    per_win = (n_cap + 1) * w_cap * 4 * (NPLANES + 3)
    max_b = max(1, DEVICE_BUDGET // per_win)
    for lo in range(0, len(on_device), max_b):
        hi = min(lo + max_b, len(on_device))
        t0 = time.perf_counter()
        batch = poa_batch_from_numpy(garrs[lo:hi], seq_arr[lo:hi], seq_len[lo:hi], device,
                                     p_slots)
        stats["arrays_s"] += time.perf_counter() - t0
        ai, aj, cnt = poa_align_device(batch, params, w_cap, a_cap, align_type, cache, stats)
        stats["aligned"] = stats.get("aligned", 0) + hi - lo
        for k in range(hi - lo):
            gi = on_device[lo + k]
            n = int(cnt[k])
            rk = ai[k, :n][::-1]
            cols = aj[k, :n][::-1]
            node_ids = np.asarray(graphs[gi].rank_to_node_id, np.int64)
            ids = np.where(rk < 0, -1, node_ids[np.maximum(rk, 0)])
            out[gi] = list(zip(ids.tolist(), cols.tolist()))
    return out


def msa_consensus_batch(batches, params=(2, -4, -6, -2, -25, -1), timings: dict | None = None,
                        device=None, stats: dict | None = None):
    """Consensus for many windows, their sequences aligned in device
    lockstep: round k aligns sequence k of every window that has one, then
    adds the alignments to the windows' graphs on the host.

    timings (optional dict) receives the reference driver's phase times
    (msa_spoa_omp.cpp:328: align / addToGraph / generateConsensus); stats
    the aligner's counts (see align_batch) and "rounds"."""
    device = default_device(device)
    stats = {} if stats is None else stats
    t_align = t_add = 0.0
    graphs = [PoaGraph() for _ in batches]
    cache = {}
    for k in range(max(len(b) for b in batches)):
        idxs = [i for i, b in enumerate(batches) if k < len(b)]
        t0 = time.perf_counter()
        alns = align_batch([graphs[i] for i in idxs], [batches[i][k] for i in idxs], params,
                           device=device, cache=cache, stats=stats)
        t_align += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, aln in zip(idxs, alns):
            graphs[i].add_alignment(aln, batches[i][k])
        t_add += time.perf_counter() - t0
        stats["rounds"] = stats.get("rounds", 0) + 1
    cache.clear()
    t0 = time.perf_counter()
    out = [g.generate_consensus() for g in graphs]
    if timings is not None:
        timings.update(align=t_align, add=t_add, consensus=time.perf_counter() - t0)
    return out


def msa_consensus_host(batches, params=(2, -4, -6, -2, -25, -1), timings: dict | None = None):
    """Consensus of each window by the native host engine: the whole
    window loop (convex alignment, add_alignment, the heaviest-bundle
    consensus) in C++ (gt_poa_msa_window), equal to msa_consensus_batch.
    timings, when given, gets the engine's align / add / consensus
    seconds."""
    lib = native._lib()
    phases = np.zeros(3, np.float64)
    out = []
    for batch in batches:
        if not batch:
            out.append("")
            continue
        blob = "".join(batch).encode()
        lens = np.array([len(s) for s in batch], np.int32)
        offs = np.zeros(len(batch), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        cap = int(lens.sum()) + 8
        cons = ctypes.create_string_buffer(cap)
        n = lib.gt_poa_msa_window(blob, native._p(offs), native._p(lens), len(batch), *params,
                                  cons, cap, native._p(phases))
        if n < 0:
            raise RuntimeError("consensus longer than total input bases")
        out.append(cons.raw[:n].decode())
    if timings is not None:
        timings.update(align=float(phases[0]), add=float(phases[1]), consensus=float(phases[2]))
    return out


class NativePoaGraph:
    """spoa's graph in C++ (native/poagraph.cpp), the oracle PoaGraph's
    contract: add_alignment, generate_consensus, the rank-space arrays of
    graph_to_arrays, and the native convex alignment (`align`).
    `to_python()` rebuilds the oracle graph."""

    def __init__(self):
        self.lib = native._lib()
        self.h = self.lib.gt_poa_new()

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.gt_poa_free(self.h)
            self.h = None

    def n_nodes(self) -> int:
        return int(self.lib.gt_poa_n_nodes(self.h))

    def align(self, sequence: str, params=(2, -4, -6, -2, -25, -1), align_type: str = "nw"):
        """The convex alignment of `sequence` to this graph (poaalign.cpp,
        the oracle's convex_align): [(node_id or -1, position or -1)]."""
        atype = {"nw": 0, "sw": 1, "ov": 2}[align_type]
        cap = self.n_nodes() + len(sequence) + 8
        while True:
            nid, pos = np.empty(cap, np.int32), np.empty(cap, np.int32)
            cnt = self.lib.gt_poa_align(self.h, sequence.encode(), len(sequence), *params, atype,
                                        native._p(nid), native._p(pos), cap)
            if cnt >= 0:
                return list(zip(nid[:cnt].tolist(), pos[:cnt].tolist()))
            cap *= 2

    def add_alignment(self, alignment, sequence: str, weights=None):
        if weights is not None:
            raise ValueError("the native graph takes unit weights only")
        nid = np.array([a for a, _ in alignment], np.int32)
        pos = np.array([b for _, b in alignment], np.int32)
        self.lib.gt_poa_add_alignment(self.h, native._p(nid), native._p(pos), len(alignment),
                                      sequence.encode(), len(sequence))

    def generate_consensus(self) -> str:
        cap = self.n_nodes() + 1
        buf = ctypes.create_string_buffer(cap)
        n = self.lib.gt_poa_consensus(self.h, buf, cap)
        if n < 0:
            raise RuntimeError("consensus overflow")
        return buf.raw[:n].decode()

    def arrays(self, n_cap: int, p_cap: int, code_map):
        """graph_to_arrays' dict and the rank -> node id list, or (None,
        None) past n_cap nodes or p_cap predecessors."""
        code_char = np.zeros(n_cap, np.uint8)
        preds = np.zeros((n_cap, p_cap), np.int32)
        npreds = np.zeros(n_cap, np.int32)
        out_empty = np.zeros(n_cap, np.uint8)
        rank = np.zeros(n_cap, np.int32)
        n_out = np.zeros(1, np.int64)
        p = native._p
        if self.lib.gt_poa_arrays(self.h, n_cap, p_cap, p(code_char), p(preds), p(npreds),
                                  p(out_empty), p(rank), p(n_out)) != 0:
            return None, None
        n = int(n_out[0])
        glob = np.full(256, 9, np.int64)
        for ch, v in code_map.items():
            glob[ord(ch)] = v
        code = np.zeros(n_cap, np.int32)
        code[:n] = glob[code_char[:n]]
        return ({"code": code, "preds": preds, "npreds": npreds,
                 "out_empty": out_empty.astype(bool), "n_nodes": np.int32(n)},
                rank[:n].tolist())

    def to_python(self):
        """The oracle PoaGraph of this graph (nodes, edges, ranks)."""
        n = self.n_nodes()
        ne = int(self.lib.gt_poa_n_edges(self.h))
        node_char = np.zeros(max(n, 1), np.uint8)
        eb, ee = np.zeros(max(ne, 1), np.int32), np.zeros(max(ne, 1), np.int32)
        ew = np.zeros(max(ne, 1), np.int64)
        rank = np.zeros(max(n, 1), np.int32)
        p = native._p
        self.lib.gt_poa_export(self.h, p(node_char), p(eb), p(ee), p(ew), p(rank))
        g = PoaGraph()
        for i in range(n):
            ch = chr(node_char[i])
            if ch not in g.coder:
                g.coder[ch] = len(g.decoder)
                g.decoder.append(ch)
            g.add_node(g.coder[ch])
        for e in range(ne):
            g.add_edge(int(eb[e]), int(ee[e]), int(ew[e]))
        g.rank_to_node_id = rank[:n].tolist()
        return g
