"""Partial-order alignment oracle (spoa semantics).

The port's own copy of genomicsbench_palisade_tpu/ops/oracle/poa.py (the
port imports nothing of the JAX package).  The port's device aligner
(ops/poa.py) grows this graph on the host between its rounds.

Semantics source (tools/spoa, HE fork — plaintext logic):
  * src/sisd_alignment_engine.cpp:94-241 (matrix init), :659-907 (convex
    Needleman-Wunsch over the DAG + traceback with extend_left/up repair)
  * src/graph.cpp:97-123 (node/edge add, edge weight accumulation),
    :174-330 (add_alignment: node fusion on matching base, aligned-node
    rings, head/tail chains), :364-423 (DFS topological sort visiting
    in-edges then aligned nodes), :562-640 (traverse_heaviest_bundle with
    the score/predecessor tie-break and branch_completion restart)
  * benchmarks/poa/msa_spoa_omp.cpp:264-270 (scores m=2 x=-4 o1=-4 e1=-2
    o2=-24 e2=-1; AlignmentType 1 = kNW; convex subtype), :441-458
    (per-batch consensus)

All sequence weights are 1 (driver default), so every edge traversal adds
prev_weight + weight = 2 to the edge's total weight.
"""

from __future__ import annotations

from dataclasses import dataclass, field

NEG_INF = -(1 << 30)  # spoa kNegativeInfinity is int32 min/2-ish; any deep sentinel


@dataclass
class PoaParams:
    m: int = 2
    n: int = -4   # mismatch
    g: int = -6   # oe1 = o1+e1: spoa takes COMBINED open+extend
    e: int = -2   # gap extend 1      (msa_spoa_omp.cpp:341,309-312)
    q: int = -25  # oe2 = o2+e2
    c: int = -1   # gap extend 2


@dataclass
class Node:
    id: int
    code: int
    in_edges: list = field(default_factory=list)  # edge indices
    out_edges: list = field(default_factory=list)
    aligned_nodes_ids: list = field(default_factory=list)


@dataclass
class Edge:
    begin: int
    end: int
    total_weight: int


class PoaGraph:
    def __init__(self):
        self.nodes: list[Node] = []
        self.edges: list[Edge] = []
        self.coder = {}
        self.decoder = []
        self.num_sequences = 0
        self.rank_to_node_id: list[int] = []
        self.consensus: list[int] = []

    # ---- construction ----------------------------------------------------
    def add_node(self, code: int) -> int:
        nid = len(self.nodes)
        self.nodes.append(Node(nid, code))
        return nid

    def add_edge(self, begin: int, end: int, weight: int):
        for ei in self.nodes[begin].out_edges:
            if self.edges[ei].end == end:
                self.edges[ei].total_weight += weight
                return
        ei = len(self.edges)
        self.edges.append(Edge(begin, end, weight))
        self.nodes[begin].out_edges.append(ei)
        self.nodes[end].in_edges.append(ei)

    def _add_sequence_chain(self, codes, weights, begin, end):
        if begin == end:
            return -1
        first = self.add_node(codes[begin])
        for i in range(begin + 1, end):
            nid = self.add_node(codes[i])
            self.add_edge(nid - 1, nid, weights[i - 1] + weights[i])
        return first

    def add_alignment(self, alignment, sequence: str, weights=None):
        """alignment: list of (node_id or -1, seq_pos or -1) pairs."""
        if not sequence:
            return
        if weights is None:
            weights = [1] * len(sequence)
        for ch in sequence:
            if ch not in self.coder:
                self.coder[ch] = len(self.decoder)
                self.decoder.append(ch)
        codes = [self.coder[ch] for ch in sequence]

        if not alignment:
            begin_node_id = self._add_sequence_chain(codes, weights, 0, len(codes))
            self.num_sequences += 1
            self.topological_sort()
            return

        valid = [j for (_nid, j) in alignment if j != -1]
        tmp = len(self.nodes)
        begin_node_id = self._add_sequence_chain(codes, weights, 0, valid[0])
        head = -1 if tmp == len(self.nodes) else len(self.nodes) - 1
        tail = self._add_sequence_chain(codes, weights, valid[-1] + 1, len(codes))
        prev_weight = 0 if head == -1 else weights[valid[0] - 1]

        for nid, j in alignment:
            if j == -1:
                continue
            letter = sequence[j]
            if nid == -1:
                new_id = self.add_node(self.coder[letter])
            else:
                if self.decoder[self.nodes[nid].code] == letter:
                    new_id = nid
                else:
                    aligned_to = -1
                    for aid in self.nodes[nid].aligned_nodes_ids:
                        if self.decoder[self.nodes[aid].code] == letter:
                            aligned_to = aid
                            break
                    if aligned_to == -1:
                        new_id = self.add_node(self.coder[letter])
                        for aid in self.nodes[nid].aligned_nodes_ids:
                            self.nodes[new_id].aligned_nodes_ids.append(aid)
                            self.nodes[aid].aligned_nodes_ids.append(new_id)
                        self.nodes[new_id].aligned_nodes_ids.append(nid)
                        self.nodes[nid].aligned_nodes_ids.append(new_id)
                    else:
                        new_id = aligned_to
            if begin_node_id == -1:
                begin_node_id = new_id
            if head != -1:
                self.add_edge(head, new_id, prev_weight + weights[j])
            head = new_id
            prev_weight = weights[j]

        if tail != -1:
            self.add_edge(head, tail, prev_weight + weights[valid[-1] + 1])
        self.num_sequences += 1
        self.topological_sort()

    # ---- topological sort (graph.cpp:364-423, DFS with aligned groups) ----
    def topological_sort(self):
        self.rank_to_node_id = []
        marks = [0] * len(self.nodes)
        check_aligned = [True] * len(self.nodes)
        for i in range(len(self.nodes)):
            if marks[i] != 0:
                continue
            stack = [i]
            while stack:
                nid = stack[-1]
                valid = True
                if marks[nid] != 2:
                    for ei in self.nodes[nid].in_edges:
                        b = self.edges[ei].begin
                        if marks[b] != 2:
                            stack.append(b)
                            valid = False
                    if check_aligned[nid]:
                        for aid in self.nodes[nid].aligned_nodes_ids:
                            if marks[aid] != 2:
                                stack.append(aid)
                                check_aligned[aid] = False
                                valid = False
                    if valid:
                        marks[nid] = 2
                        if check_aligned[nid]:
                            self.rank_to_node_id.append(nid)
                            for aid in self.nodes[nid].aligned_nodes_ids:
                                self.rank_to_node_id.append(aid)
                    else:
                        marks[nid] = 1
                if valid:
                    stack.pop()

    # ---- consensus (graph.cpp:562-690) ------------------------------------
    def traverse_heaviest_bundle(self):
        n = len(self.nodes)
        preds = [-1] * n
        scores = [-1] * n
        max_id = self.rank_to_node_id[0] if self.rank_to_node_id else 0
        max_id = 0
        for nid in self.rank_to_node_id:
            for ei in self.nodes[nid].in_edges:
                e = self.edges[ei]
                if scores[nid] < e.total_weight or (
                    scores[nid] == e.total_weight
                    and scores[preds[nid]] <= scores[e.begin]
                ):
                    scores[nid] = e.total_weight
                    preds[nid] = e.begin
            if preds[nid] != -1:
                scores[nid] += scores[preds[nid]]
            if scores[max_id] < scores[nid]:
                max_id = nid

        if self.nodes[max_id].out_edges:
            node_id_to_rank = [0] * n
            for r, nid in enumerate(self.rank_to_node_id):
                node_id_to_rank[nid] = r
            while self.nodes[max_id].out_edges:
                max_id = self._branch_completion(scores, preds, node_id_to_rank[max_id])

        self.consensus = []
        while preds[max_id] != -1:
            self.consensus.append(max_id)
            max_id = preds[max_id]
        self.consensus.append(max_id)
        self.consensus.reverse()

    def _branch_completion(self, scores, preds, rank):
        nid0 = self.rank_to_node_id[rank]
        for ei in self.nodes[nid0].out_edges:
            end = self.edges[ei].end
            for oei in self.nodes[end].in_edges:
                if self.edges[oei].begin != nid0:
                    scores[self.edges[oei].begin] = -1
        max_score = 0
        max_id = 0
        for r in range(rank + 1, len(self.rank_to_node_id)):
            nid = self.rank_to_node_id[r]
            scores[nid] = -1
            preds[nid] = -1
            for ei in self.nodes[nid].in_edges:
                e = self.edges[ei]
                if scores[e.begin] == -1:
                    continue
                if scores[nid] < e.total_weight or (
                    scores[nid] == e.total_weight
                    and scores[preds[nid]] <= scores[e.begin]
                ):
                    scores[nid] = e.total_weight
                    preds[nid] = e.begin
            if preds[nid] != -1:
                scores[nid] += scores[preds[nid]]
            if max_score < scores[nid]:
                max_score = scores[nid]
                max_id = nid
        return max_id

    def generate_consensus(self) -> str:
        self.traverse_heaviest_bundle()
        return "".join(self.decoder[self.nodes[nid].code] for nid in self.consensus)


def convex_align(sequence: str, graph: PoaGraph,
                 params: PoaParams = PoaParams(), align_type: str = "nw"):
    """SisdAlignmentEngine::convex (sisd_alignment_engine.cpp:659-907)
    for all three AlignmentTypes (alignment_engine.hpp:19-24):

      nw  global (the benchmark driver's hardcoded type,
          msa_spoa_omp.cpp:264): H boundaries from the gap chains; max
          cell restricted to the last column of sink rows; traceback to
          (0, 0).
      sw  local: zero boundaries, every cell clamped at 0
          (sisd_alignment_engine.cpp:747-749), max over all cells,
          traceback stops at H == 0.
      ov  overlap: NW-style top row / zero first column
          (sisd_alignment_engine.cpp:214-240), max over all cells of
          sink rows, traceback stops at i == 0 or j == 0.

    Returns the alignment as a list of (node_id, seq_pos) with -1 gaps.
    """
    p = params
    if not graph.nodes or not sequence:
        return []
    w = len(sequence) + 1
    h = len(graph.nodes) + 1
    rank_to_node_id = graph.rank_to_node_id
    node_rank = {nid: r for r, nid in enumerate(rank_to_node_id)}

    # profiles
    prof = {}
    for code in range(len(graph.decoder)):
        ch = graph.decoder[code]
        prof[code] = [0] + [p.m if ch == sequence[j] else p.n for j in range(w - 1)]

    H = [[0] * w for _ in range(h)]
    F = [[0] * w for _ in range(h)]
    E = [[0] * w for _ in range(h)]
    O = [[0] * w for _ in range(h)]
    Q = [[0] * w for _ in range(h)]

    # init (initialize(): kConvex boundary gap chains for every type;
    # the H boundary is the only type-dependent part)
    assert align_type in ("nw", "sw", "ov"), align_type
    for j in range(1, w):
        O[0][j] = NEG_INF
        Q[0][j] = p.q + (j - 1) * p.c
        F[0][j] = NEG_INF
        E[0][j] = p.g + (j - 1) * p.e
        if align_type in ("nw", "ov"):
            H[0][j] = max(Q[0][j], E[0][j])
    for r in range(1, h):
        node = graph.nodes[rank_to_node_id[r - 1]]
        pen_o = p.q - p.c if not node.in_edges else NEG_INF
        pen_f = p.g - p.e if not node.in_edges else NEG_INF
        for ei in node.in_edges:
            pi = node_rank[graph.edges[ei].begin] + 1
            pen_o = max(pen_o, O[pi][0])
            pen_f = max(pen_f, F[pi][0])
        O[r][0] = pen_o + p.c
        Q[r][0] = NEG_INF
        F[r][0] = pen_f + p.e
        E[r][0] = NEG_INF
        if align_type == "nw":
            H[r][0] = max(O[r][0], F[r][0])

    max_score = 0 if align_type == "sw" else NEG_INF
    max_i = max_j = -1

    for nid in rank_to_node_id:
        node = graph.nodes[nid]
        cp = prof[node.code]
        i = node_rank[nid] + 1
        preds = [node_rank[graph.edges[ei].begin] + 1 for ei in node.in_edges]
        if not preds:
            preds = [0]
        pi = preds[0]
        for j in range(1, w):
            F[i][j] = max(H[pi][j] + p.g, F[pi][j] + p.e)
            O[i][j] = max(H[pi][j] + p.q, O[pi][j] + p.c)
            H[i][j] = H[pi][j - 1] + cp[j]
        for pi in preds[1:]:
            for j in range(1, w):
                F[i][j] = max(F[i][j], H[pi][j] + p.g, F[pi][j] + p.e)
                O[i][j] = max(O[i][j], H[pi][j] + p.q, O[pi][j] + p.c)
                H[i][j] = max(H[i][j], H[pi][j - 1] + cp[j])
        out_empty = not node.out_edges
        for j in range(1, w):
            E[i][j] = max(H[i][j - 1] + p.g, E[i][j - 1] + p.e)
            Q[i][j] = max(H[i][j - 1] + p.q, Q[i][j - 1] + p.c)
            H[i][j] = max(H[i][j], F[i][j], E[i][j], O[i][j], Q[i][j])
            if align_type == "sw":
                H[i][j] = max(H[i][j], 0)
                hit = True
            elif align_type == "nw":
                hit = j == w - 1 and out_empty
            else:  # ov
                hit = out_empty
            if hit and max_score < H[i][j]:
                max_score = H[i][j]
                max_i, max_j = i, j

    # traceback (type-dependent stop conditions, :770-778)
    def _more(i, j):
        if align_type == "sw":
            return H[i][j] != 0
        if align_type == "ov":
            return not (i == 0 or j == 0)
        return not (i == 0 and j == 0)

    alignment = []
    i, j = max_i, max_j
    while _more(i, j):
        h_ij = H[i][j]
        found = False
        extend_left = extend_up = False
        prev_i = prev_j = 0
        if i != 0 and j != 0:
            node = graph.nodes[rank_to_node_id[i - 1]]
            mc = prof[node.code][j]
            pred_list = (
                [node_rank[graph.edges[ei].begin] + 1 for ei in node.in_edges]
                if node.in_edges
                else [0]
            )
            for pi in pred_list:
                if h_ij == H[pi][j - 1] + mc:
                    prev_i, prev_j = pi, j - 1
                    found = True
                    break
        if not found and i != 0:
            node = graph.nodes[rank_to_node_id[i - 1]]
            pred_list = (
                [node_rank[graph.edges[ei].begin] + 1 for ei in node.in_edges]
                if node.in_edges
                else [0]
            )
            for pi in pred_list:
                c1 = h_ij == F[pi][j] + p.e
                c2 = h_ij == H[pi][j] + p.g
                c3 = h_ij == O[pi][j] + p.c
                c4 = h_ij == H[pi][j] + p.q
                extend_up_local = c1 or (not c2 and c3)
                if c1 or c2 or c3 or c4:
                    extend_up |= extend_up_local
                    prev_i, prev_j = pi, j
                    found = True
                    break
        if not found and j != 0:
            c1 = h_ij == E[i][j - 1] + p.e
            c2 = h_ij == H[i][j - 1] + p.g
            c3 = h_ij == Q[i][j - 1] + p.c
            c4 = h_ij == H[i][j - 1] + p.q
            if c1 or c2 or c3 or c4:
                extend_left |= c1 or (not c2 and c3)
                prev_i, prev_j = i, j - 1
                found = True

        alignment.append(
            (
                -1 if i == prev_i else rank_to_node_id[i - 1],
                -1 if j == prev_j else j - 1,
            )
        )
        i, j = prev_i, prev_j

        if extend_left:
            while True:
                alignment.append((-1, j - 1))
                j -= 1
                if E[i][j] + p.e != E[i][j + 1] and Q[i][j] + p.c != Q[i][j + 1]:
                    break
        elif extend_up:
            while True:
                stop = True
                prev_i = 0
                node = graph.nodes[rank_to_node_id[i - 1]]
                for ei in node.in_edges:
                    pi = node_rank[graph.edges[ei].begin] + 1
                    if F[i][j] == F[pi][j] + p.e or O[i][j] == O[pi][j] + p.c:
                        prev_i = pi
                        stop = False
                        break
                if stop:
                    for ei in node.in_edges:
                        pi = node_rank[graph.edges[ei].begin] + 1
                        if F[i][j] == H[pi][j] + p.g or O[i][j] == H[pi][j] + p.q:
                            prev_i = pi
                            break
                alignment.append((rank_to_node_id[i - 1], -1))
                i = prev_i
                if stop or i == 0:
                    break

    alignment.reverse()
    return alignment


def convex_nw_align(sequence: str, graph: PoaGraph,
                    params: PoaParams = PoaParams()):
    """kNW convex alignment — the benchmark driver's hardcoded engine
    type (msa_spoa_omp.cpp:264)."""
    return convex_align(sequence, graph, params, align_type="nw")


def msa_consensus(seqs, params: PoaParams = PoaParams()) -> str:
    """Per-batch POA consensus (the poa driver's per-batch loop)."""
    graph = PoaGraph()
    for s in seqs:
        aln = convex_nw_align(s, graph, params)
        graph.add_alignment(aln, s)
    return graph.generate_consensus()
