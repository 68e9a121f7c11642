"""The port's entry points for a driver: one forward step and a sharded dry run.

Counterpart of __graft_entry__.py (`_example_batch`, `entry`,
`dryrun_multichip`), which runs the JAX package.  `entry(device)` gives the
PairHMM f32 forward step (the phmm_forward_f32 kernel on CUDA, its plain
version on the CPU) and its example arguments; `dryrun_multichip(n)` runs
every sharded path of parallel/dp.py on n gloo ranks on the CPU at the JAX
dry run's shapes and seeds, with its checks.
"""

from __future__ import annotations

import numpy as np
import torch

from . import default_device
from .ops import phmm as P

PHMM_KEYS = ("rs_row", "q", "i", "d", "c", "hap", "rslen", "haplen")


def _example_batch(b=8, r_pad=64, h_pad=128, seed=0):
    """__graft_entry__._example_batch's testcases, packed by the port."""
    rng = np.random.default_rng(seed)
    reads, haps, pairs = [], [], []
    for i in range(b):
        rl, hl = int(rng.integers(20, r_pad - 1)), int(rng.integers(30, h_pad))
        reads.append({"bases": rng.integers(0, 4, rl), "q": rng.integers(36, 60, rl),
                      "i": rng.integers(36, 60, rl), "d": rng.integers(36, 60, rl),
                      "c": rng.integers(36, 60, rl)})
        haps.append(rng.integers(0, 4, hl))
        pairs.append((i, i))
    return P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)


def entry(device=None):
    """(fn, example_args): fn(rs_row, q, i, d, c, hap, rslen, haplen) is the
    f32 PairHMM forward step, returning the log10 likelihoods [B] as a
    float32 tensor; example_args are the example batch's tensors on
    `device` (CUDA unless the caller asks for the CPU)."""
    batch = P.as_device_batch(_example_batch(), default_device(device))

    def fn(rs_row, q, i, d, c, hap, rslen, haplen):
        log10, _raw, _fallback = P.phmm_forward(dict(zip(PHMM_KEYS, (rs_row, q, i, d, c, hap,
                                                                      rslen, haplen))))
        return torch.from_numpy(log10)

    return fn, tuple(batch[k] for k in PHMM_KEYS)


def _dryrun_rank(rank: int, n_devices: int):
    """One rank of dryrun_multichip: the JAX dry run's steps (its shapes,
    seeds and checks), each sharded path held to the port's single-device
    run where the JAX dry run holds it to its own."""
    from .index.builder import build_arrays
    from .ops import abea as AB
    from .ops import bsw as W
    from .ops import chain as C
    from .ops import kmer as K
    from .ops import poa as PP
    from .ops.oracle.abea import get_kmer_rank
    from .ops.oracle.poa import PoaGraph
    from .parallel import dp, mesh as M

    mesh = M.make_mesh(n_devices, device="cpu")
    cpu = torch.device("cpu")

    # phmm: data-parallel forward step
    batch = _example_batch(b=2 * n_devices, r_pad=32, h_pad=32)
    rows, n = M.shard_batch(batch, mesh)
    log10, _res, fb = dp.phmm_forward_sharded(mesh, rows)
    log10, fb = log10[:n], fb[:n]
    assert np.isfinite(log10[~fb]).all(), log10

    # kmer: key-range all_to_all and summed metrics
    rng = np.random.default_rng(1)
    reads = ["".join(rng.choice(list("ACGT"), 64)) for _ in range(4 * n_devices)]
    bases, lengths = K.encode_reads_np(reads)
    total = dp.count_kmers_sharded(mesh, bases, lengths, k=17)["total_kmers"]
    assert 0 < total <= sum(len(r) - 17 for r in reads), total

    # grm: variant-sharded products, summed
    m, ns = 8 * n_devices, 16
    geno = rng.choice([0, 1, 2, 3], size=(m, ns)).astype(np.int8)
    miss = geno == 3
    g64 = np.where(miss, 0.0, geno.astype(np.float64))
    freqs = g64.sum(1) / np.maximum(2.0 * (~miss).sum(1), 1.0)
    var = 2.0 * freqs * (1.0 - freqs)
    ok = var > 2 ** -44
    isd = np.where(ok, 1.0 / np.sqrt(np.where(ok, var, 1.0)), 0.0)
    sums, counts = dp.grm_sharded(mesh, geno, (2 * freqs).astype(np.float32),
                                  isd.astype(np.float32), ok, block=8)
    assert bool(torch.isfinite(sums).all())
    assert tuple(counts.shape) == (ns, ns)

    # chain: anchor-axis shards with the halo pipeline
    nanch = 48 * n_devices
    xs = np.cumsum(rng.integers(1, 40, nanch)).astype(np.int64) + 1000
    ys = np.maximum(xs + rng.integers(-200, 200, nanch), 0)
    call = C.prepare_call(xs, ys, avg_qspan=22.5)
    got = dp.chain_dp_halo_sharded(mesh, call, w=16)
    want = C.chain_call(C.window_clamp(call, 16), cpu)
    for g, w_, name in zip(got, want, ("score", "parent", "peak")):
        assert np.array_equal(g, w_), f"halo-sharded chain {name} mismatch"

    # bsw: data-parallel extension
    bpairs = []
    for _ in range(2 * n_devices):
        ql, tl = int(rng.integers(5, 40)), int(rng.integers(5, 60))
        bpairs.append((rng.integers(0, 5, ql), rng.integers(0, 5, tl), int(rng.integers(1, 40))))
    from .convert import bsw_batch_from_numpy

    bb, params = bsw_batch_from_numpy(W.prepare_pairs(bpairs, q_pad=64, t_pad=64), cpu)
    assert torch.equal(dp.bsw_batch_sharded(mesh, bb, params), W.bsw_extend(bb, params)), (
        "sharded bsw mismatch")

    # fmi: block-range-sharded index search
    genome = rng.integers(0, 4, 2048).astype(np.uint8)
    findex = build_arrays(genome, device="cpu")
    fb_, fl = 2 * n_devices, 20
    fenc = np.zeros((fb_, fl), np.int32)
    flen = np.zeros(fb_, np.int32)
    for i in range(fb_):
        n2 = int(rng.integers(8, fl + 1))
        s2 = int(rng.integers(0, len(genome) - n2))
        fenc[i, :n2] = genome[s2 : s2 + n2]
        flen[i] = n2
    _k, _l, gs = dp.fmi_backward_search_sharded(mesh, findex, fenc, flen)
    assert bool((gs > 0).all()), "sharded fmi lost a true substring"

    # poa: window-sharded graph alignment
    wb = 2 * n_devices
    bases_s = ["".join(rng.choice(list("ACGT"), 24)) for _ in range(wb)]
    graphs = [PoaGraph() for _ in range(wb)]
    firsts = PP.align_batch(graphs, bases_s, device=cpu)  # empty graphs: the oracle
    for g, a, s in zip(graphs, firsts, bases_s):
        g.add_alignment(a, s)
    seqs = []
    for s in bases_s:
        cs = list(s)
        for p in np.nonzero(rng.random(len(cs)) < 0.1)[0]:
            cs[p] = "ACGT"[rng.integers(0, 4)]
        seqs.append("".join(cs))
    pparams = (2, -4, -6, -2, -25, -1)
    garrs, seq_arr, seq_len, w_cap, a_cap = PP.round_arrays(graphs, seqs)
    garr_stack = {k: np.stack([a[k] for a in garrs]) for k in garrs[0]}
    packed = dp.poa_align_sharded(mesh, seq_arr, seq_len, garr_stack, pparams, w_cap, a_cap)
    from .convert import poa_batch_from_numpy

    ai, aj, cnt = PP.poa_align_device(poa_batch_from_numpy(garrs, seq_arr, seq_len, cpu),
                                      pparams, w_cap, a_cap)
    assert np.array_equal(packed, np.concatenate([ai, aj, cnt[:, None]], axis=1)), (
        "sharded poa packed-alignment mismatch")

    # abea: read-sharded band fill
    nr = 2 * n_devices
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    aseqs, aevs = [], []
    for _ in range(nr):
        seq = "".join(rng.choice(list("ACGT"), 24))
        raw = []
        for p in range(len(seq) - 5):
            raw.extend(model["level_mean"][get_kmer_rank(seq[p : p + 6])]
                       + rng.normal(0, 0.3, int(rng.integers(1, 3))))
        aseqs.append(seq)
        aevs.append(np.asarray(raw, np.float32))
    abatch, _idx = AB.prepare_batch(aseqs, aevs, model, [1.0] * nr, [0.0] * nr)
    got_fill = dp.abea_fill_sharded(mesh, abatch)
    from .convert import abea_batch_from_numpy

    want_fill = AB.abea_fill(abea_batch_from_numpy(abatch, cpu))
    for key, val in got_fill.items():
        assert torch.equal(val, want_fill[key]), f"sharded abea {key} mismatch"


def dryrun_multichip(n_devices: int) -> None:
    """One step of every sharded path on n_devices gloo ranks on the CPU (the
    JAX dry run forces a virtual CPU mesh): phmm, kmer, grm, chain, bsw, fmi,
    poa and the abea fill, at its shapes, each checked.  Raises if a rank
    fails."""
    from .parallel.mesh import spawn

    spawn(_dryrun_rank, n_devices, (n_devices,))
