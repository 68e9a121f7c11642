"""ctypes bindings over the port's own build of native/*.cpp.

The port's copy of genomicsbench_palisade_tpu/io/native.py, with the JAX
module's names, signatures and return values:

- readers: `parse_reads_native` (FASTA/FASTQ straight to codes),
  `parse_pairs_struct_native` and `sub48_native` (the bsw pair file),
  `read_bam_native` and `read_bam_region_native` (BAM decode);
- nanopore: `detect_events_native` (scrappie's event detector),
  `eventalign_realign_native` and `eventalign_emit_native` (f5c's
  eventalign realign and TSV), `abea_traceback_native` (the abea walk and
  QC on the host), `ctc_beam_native` (bonito's CTC prefix beam);
- `kmer_count_native` (Flye's counter on the host) and
  `minimizer_counts_native` (its minimizer walk);
- `sais` (the index builder's suffix array), `dbg_window_native` (the dbg
  driver's window engine), the three pileup engines
  (`pileup_events_native`, `pileup_events_cols_native`,
  `pileup_matrix_native`) and `fmi_search_native` (the fmi CLI's host
  engine).

`_lib()` also types the entry points that the JAX package binds in the
modules that call them: `gt_mom_scalings` and `gt_eventalign_scaling`
(ops/eventalign.py), `gt_abea_align` (ops/abea.py), `gt_phmm_f64`
(ops/phmm_f64.py) and the poa graph and aligner (ops/poa.py).

The library is built from native/ at first use by
`utils.native_build` (into build/native/, never native/ itself).  Unlike
the JAX module, nothing here returns None for a missing library: a failed
build raises, and no caller falls back to a Python path quietly.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sys

import numpy as np

from ..utils import native_build
from .bam import CIGAR_OPS

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with this module's functions typed."""
    lib = native_build.load()
    lib.gt_sais_u8.restype = ctypes.c_int
    lib.gt_sais_u8.argtypes = [_P, _I64, _I64, _P]
    lib.gt_bam_open_region.restype = _P
    lib.gt_bam_open_region.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.c_int32, _I64, _I64, ctypes.c_int32, ctypes.c_int32]
    for fn in ("gt_bam_n_records", "gt_bam_names_bytes", "gt_bam_cigar_words",
               "gt_bam_seq_bytes"):
        getattr(lib, fn).restype = _I64
        getattr(lib, fn).argtypes = [_P]
    lib.gt_bam_copy_out.argtypes = [_P] * 12
    lib.gt_bam_copy_span.argtypes = [_P, _P]
    lib.gt_bam_free.argtypes = [_P]
    lib.gt_dbg_window.restype = _P
    lib.gt_dbg_window.argtypes = [ctypes.c_char_p, _I64, _I64, ctypes.c_char_p, _P, _P, _P,
                                  _I64, _I64, _I64, _I64]
    for fn in ("gt_dbg_n_nodes", "gt_dbg_n_bubbles", "gt_dbg_seq_bytes",
               "gt_pileup_n_events", "gt_pileup_n_ins", "gt_pileup_layout_cols",
               "gt_fmi_n1", "gt_fmi_n2", "gt_fmi_n3"):
        getattr(lib, fn).restype = _I64
        getattr(lib, fn).argtypes = [_P]
    lib.gt_dbg_copy.argtypes = [_P, _P]
    lib.gt_dbg_free.argtypes = [_P]
    lib.gt_pileup_events.restype = _P
    lib.gt_pileup_events.argtypes = [_P] * 7 + [_I64, _P] + [_I64] * 3
    lib.gt_pileup_copy.argtypes = [_P] * 8
    lib.gt_pileup_free.argtypes = [_P]
    lib.gt_pileup_layout.restype = _P
    lib.gt_pileup_layout.argtypes = [_P] * 4 + [_I64] * 3
    lib.gt_pileup_fill.argtypes = [_P] * 8 + [_I64, _P] + [_I64] * 4 + [_P] * 3
    lib.gt_pileup_layout_free.argtypes = [_P]
    fmi_args = [_P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_int]
    lib.gt_fmi_run.restype = _P
    lib.gt_fmi_run.argtypes = [_P, _P, _I64] + fmi_args
    lib.gt_fmi_run2.restype = _P
    lib.gt_fmi_run2.argtypes = [_P, _P, _P, _I64] + fmi_args
    lib.gt_fmi_copy.argtypes = [_P] * 7
    lib.gt_fmi_free.argtypes = [_P]
    lib.gt_alloc_pages.restype = _P
    lib.gt_alloc_pages.argtypes = [_I64, ctypes.c_int]
    lib.gt_free_pages.argtypes = [_P, _I64]
    # readers
    lib.gt_parse_reads.restype = _P
    lib.gt_parse_reads.argtypes = [ctypes.c_char_p, _I64]
    for fn in ("gt_num_reads", "gt_total_bases", "gt_num_quals"):
        getattr(lib, fn).restype = _I64
        getattr(lib, fn).argtypes = [_P]
    lib.gt_copy_out.argtypes = [_P] * 5
    lib.gt_free_reads.argtypes = [_P]
    lib.gt_pairs_count.restype = _I64
    lib.gt_pairs_count.argtypes = [_P, _I64]
    lib.gt_pairs_parse.argtypes = [_P, _I64, _I64] + [_P] * 5
    lib.gt_sub48.argtypes = [_P, _I64, _P]
    lib.gt_bam_open.restype = _P
    lib.gt_bam_open.argtypes = [ctypes.c_char_p]
    for fn in ("gt_bam_n_refs", "gt_bam_refnames_bytes"):
        getattr(lib, fn).restype = _I64
        getattr(lib, fn).argtypes = [_P]
    lib.gt_bam_copy_refs.argtypes = [_P] * 3
    # nanopore
    lib.gt_detect_events.restype = _I64
    lib.gt_detect_events.argtypes = [_P, _I64] + [_P] * 4 + [_I64]
    lib.gt_mom_scalings.argtypes = [_P, _I64, _P, _I64, _P, _P]
    lib.gt_eventalign_scaling.restype = ctypes.c_int32
    lib.gt_eventalign_scaling.argtypes = [_P, _I64, _P, _P, _I64] + [_P] * 6
    lib.gt_eventalign_realign.restype = _I64
    lib.gt_eventalign_realign.argtypes = (
        [_P, _I64, _I64] + [_P] * 3 + [_I64, ctypes.c_int32, _I64, _P, _I64]
        + [ctypes.c_float] * 4 + [_P] * 4 + [_I64, ctypes.c_double] + [_P] * 3 + [_I64])
    lib.gt_eventalign_emit.restype = _I64
    lib.gt_eventalign_emit.argtypes = ([_I64, _P, _P, ctypes.c_char_p, ctypes.c_char_p, _I64]
                                       + [_P] * 6 + [ctypes.c_char_p] * 2 + [_P, _I64])
    lib.gt_abea_align.restype = _I64
    lib.gt_abea_align.argtypes = ([_P, _I64, _P, _I64] + [_P] * 3
                                  + [ctypes.c_float, ctypes.c_float, ctypes.c_int32, _P, _P, _I64])
    lib.gt_abea_traceback.restype = ctypes.c_int
    lib.gt_abea_traceback.argtypes = ([_I64] + [_P] * 12 + [_I64] * 4 + [ctypes.c_double]
                                      + [_P] * 2 + [_I64])
    lib.gt_ctc_beam.restype = _I64
    lib.gt_ctc_beam.argtypes = [_P, _I64, _I64, _I64, ctypes.c_double, _P, _I64]
    # kmer
    lib.gt_kmer_count.restype = ctypes.c_int32
    lib.gt_kmer_count.argtypes = [_P] * 3 + [_I64] + [ctypes.c_int32] * 4 + [_P] * 3
    lib.gt_minimizers_count.restype = _P
    lib.gt_minimizers_count.argtypes = [_P] * 3 + [_I64] * 4
    lib.gt_minimizers_size.restype = _I64
    lib.gt_minimizers_size.argtypes = [_P]
    lib.gt_minimizers_copy.argtypes = [_P] * 3
    lib.gt_minimizers_free.argtypes = [_P]
    # phmm's double pass
    lib.gt_phmm_f64.argtypes = [_P] * 8 + [_I64] * 3 + [_P] * 2 + [ctypes.c_double, _P]
    # poa's graph and aligner
    lib.gt_poa_new.restype = _P
    lib.gt_poa_free.argtypes = [_P]
    lib.gt_poa_add_alignment.argtypes = [_P, _P, _P, _I64, ctypes.c_char_p, _I64]
    for fn in ("gt_poa_n_nodes", "gt_poa_n_edges"):
        getattr(lib, fn).restype = _I64
        getattr(lib, fn).argtypes = [_P]
    lib.gt_poa_consensus.restype = _I64
    lib.gt_poa_consensus.argtypes = [_P, _P, _I64]
    lib.gt_poa_arrays.restype = ctypes.c_int32
    lib.gt_poa_arrays.argtypes = [_P, _I64, _I64] + [_P] * 6
    lib.gt_poa_export.argtypes = [_P] * 6
    lib.gt_poa_align.restype = _I64
    lib.gt_poa_align.argtypes = [_P, ctypes.c_char_p, _I64] + [ctypes.c_int32] * 7 + [_P, _P, _I64]
    lib.gt_poa_msa_window.restype = _I64
    lib.gt_poa_msa_window.argtypes = ([_P] * 3 + [_I64] + [ctypes.c_int32] * 6
                                      + [_P, _I64, _P])
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(_P)


def sais(codes: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """Suffix array of int8/uint8 codes in [0, 255) by native SA-IS: int64[n]
    positions of the sorted suffixes of the text without a sentinel (a
    suffix that is a prefix of another sorts first).  `out` (contiguous
    int64[n]) receives it in place: at genome scale a fresh multi-GB buffer
    pays first-touch page faults, so callers embedding the SA in a larger
    array pass a view."""
    lib = _lib()
    shifted = np.ascontiguousarray(codes, dtype=np.uint8) + np.uint8(1)  # 0: the sentinel
    n = len(shifted)
    if out is not None:
        if out.dtype != np.int64 or not out.flags.c_contiguous or len(out) != n:
            raise ValueError("out must be a contiguous int64 array of the text's length")
        sa = out
    else:
        sa = np.empty(n, np.int64)
    k = int(shifted.max()) + 1 if n else 1
    rc = lib.gt_sais_u8(_p(shifted), n, k, _p(sa))
    if rc != 0:
        raise RuntimeError(f"gt_sais_u8 failed (rc {rc})")
    return sa


def _bam_cols(lib, h) -> dict:
    """A decoded BAM handle's records as the columnar dict of
    read_bam_native (gt_bam_copy_out)."""
    n = lib.gt_bam_n_records(h)
    seq_bytes = lib.gt_bam_seq_bytes(h)
    cols = {
        "ref_id": np.empty(n, np.int32),
        "pos": np.empty(n, np.int32),
        "mapq": np.empty(n, np.int32),
        "flag": np.empty(n, np.int32),
        "name_off": np.empty(n + 1, np.int64),
        "cigar_off": np.empty(n + 1, np.int64),
        "seq_off": np.empty(n + 1, np.int64),
        "cigar": np.empty(lib.gt_bam_cigar_words(h), np.uint32),
        "seq_nt16": np.empty(seq_bytes, np.uint8),
        "qual": np.empty(seq_bytes, np.uint8),
    }
    names = ctypes.create_string_buffer(int(lib.gt_bam_names_bytes(h)))
    lib.gt_bam_copy_out(h, *(_p(cols[k]) for k in ("ref_id", "pos", "mapq", "flag", "name_off")),
                        names, *(_p(cols[k]) for k in ("cigar_off", "cigar", "seq_off",
                                                       "seq_nt16", "qual")))
    cols["names"] = names.raw
    return cols


def read_bam_region_native(path: str, voff_lo: int, voff_hi: int, ref_id: int, beg: int,
                           end: int, filter_flags: int = 0, min_mapq: int = 0):
    """Native `.bai`-bounded region decode into columnar arrays.

    voff_lo/voff_hi: the virtual-offset window from the `.bai` (the bounds
    io/bam.py read_bam_region computes); records overlapping [beg, end) on
    ref_id only, flag/mapq pre-filtered.  Returns a dict: ref_id, pos, mapq,
    flag, span (int32[N]; span is a record's reference span);
    name_off/cigar_off/seq_off (int64[N+1] exclusive prefixes); names
    (bytes); cigar (uint32 raw words); seq_nt16, qual (uint8).  The
    streaming BGZF inflate keeps memory region-sized.  Raises when the
    file cannot be read."""
    lib = _lib()
    h = lib.gt_bam_open_region(os.fsencode(path), voff_lo, voff_hi, ref_id, beg, end,
                               filter_flags, min_mapq)
    if not h:
        raise OSError(f"native BAM decode failed for {path}")
    try:
        cols = _bam_cols(lib, h)
        cols["span"] = np.empty(len(cols["pos"]), np.int32)
        lib.gt_bam_copy_span(h, _p(cols["span"]))
    finally:
        lib.gt_bam_free(h)
    return cols


def dbg_window_native(ref_seq: str, ref_start: int, reads, kmer_size: int, min_qual: int,
                      min_reads: int):
    """Native colored-DBG window assembly (native/dbg.cpp; its contract is
    ops.dbg.assemble_window).  reads: list of (seq, quals, flag).  Returns
    (n_nodes, [bubble path sequences])."""
    lib = _lib()
    seqs = b"".join(s.encode() for s, _q, _f in reads)
    lens = np.array([len(s) for s, _q, _f in reads], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    quals = (np.concatenate([np.asarray(q, np.uint8) for _s, q, _f in reads])
             if reads else np.zeros(0, np.uint8))
    flags = np.array([f for _s, _q, f in reads], np.int32)
    h = lib.gt_dbg_window(ref_seq.encode(), len(ref_seq), ref_start, seqs, _p(offs),
                          _p(quals), _p(flags), len(reads), kmer_size, min_qual, min_reads)
    try:
        n_nodes = lib.gt_dbg_n_nodes(h)
        nb = lib.gt_dbg_seq_bytes(h)
        buf = ctypes.create_string_buffer(int(nb))
        lib.gt_dbg_copy(h, buf)
        bubbles = buf.raw.decode().split("\n")[:-1] if nb else []
    finally:
        lib.gt_dbg_free(h)
    return n_nodes, bubbles


def pileup_events_native(records, num2countbase, del_fwd, del_rev, num_homop: int):
    """Batched medaka event extraction (native/pileup_events.cpp; its
    contract is ops.pileup's read_events fast path, applied to every record
    in one call).  records: BamRecords already filtered for flags and mapq.
    Returns (pos, minor, feat, qstrat, rec_id, ins_pos, ins_len)."""
    op_idx = {c: i for i, c in enumerate(CIGAR_OPS)}
    seq = (np.concatenate([np.asarray(r.seq_nt16, np.uint8) for r in records])
           if records else np.zeros(0, np.uint8))
    qual = (np.concatenate([np.asarray(r.qual, np.uint8) for r in records])
            if records else np.zeros(0, np.uint8))
    seq_off = np.concatenate([[0], np.cumsum([len(r.seq_nt16) for r in records])]).astype(np.int64)
    cig = [np.array([(ln << 4) | op_idx[op] for op, ln in r.cigar], np.uint32) for r in records]
    cigar = np.concatenate(cig) if cig else np.zeros(0, np.uint32)
    cigar_off = np.concatenate([[0], np.cumsum([len(c) for c in cig])]).astype(np.int64)
    rpos = np.array([r.pos for r in records], np.int64)
    rev = np.array([1 if r.is_reverse else 0 for r in records], np.uint8)
    return pileup_events_cols_native(seq, qual, seq_off, cigar, cigar_off, rpos, rev,
                                     num2countbase, del_fwd, del_rev, num_homop)


def pileup_events_cols_native(seq, qual, seq_off, cigar, cigar_off, rpos, rev, num2countbase,
                              del_fwd, del_rev, num_homop: int):
    """pileup_events_native on columnar buffers, the layout
    read_bam_region_native returns, so the fused BAM-region path never
    builds Python record objects."""
    lib = _lib()
    arrays = [np.ascontiguousarray(a, dt) for a, dt in
              ((seq, np.uint8), (qual, np.uint8), (seq_off, np.int64), (cigar, np.uint32),
               (cigar_off, np.int64), (rpos, np.int64), (rev, np.uint8))]
    tbl = np.ascontiguousarray(num2countbase, np.int64)
    h = lib.gt_pileup_events(*(_p(a) for a in arrays), len(arrays[5]), _p(tbl), del_fwd,
                             del_rev, num_homop)
    try:
        n = lib.gt_pileup_n_events(h)
        ni = lib.gt_pileup_n_ins(h)
        out = (np.empty(n, np.int64), np.empty(n, np.int64), np.empty(n, np.int64),
               np.empty(n, np.int64), np.empty(n, np.int32), np.empty(ni, np.int64),
               np.empty(ni, np.int64))
        lib.gt_pileup_copy(h, *(_p(a) for a in out))
    finally:
        lib.gt_pileup_free(h)
    return out


def pileup_matrix_native(cols, start: int, end: int, num2countbase, del_fwd, del_rev,
                         num_homop: int, featlen: int):
    """Fused native pileup: event extraction, coverage, insertion widths and
    the (column, feature) histogram in C on the columnar region arrays
    (read_bam_region_native's output); events never reach numpy.  Returns
    (major, minor, matrix int32 [n_cols, featlen * num_homop])."""
    lib = _lib()
    seq = np.ascontiguousarray(cols["seq_nt16"], np.uint8)
    qual = np.ascontiguousarray(cols["qual"], np.uint8)
    seq_off = np.ascontiguousarray(cols["seq_off"], np.int64)
    cigar = np.ascontiguousarray(cols["cigar"], np.uint32)
    cigar_off = np.ascontiguousarray(cols["cigar_off"], np.int64)
    rpos = np.ascontiguousarray(cols["pos"], np.int64)
    rev = np.ascontiguousarray((cols["flag"] & 16) != 0, np.uint8)
    span = np.ascontiguousarray(cols["span"], np.int32)
    tbl = np.ascontiguousarray(num2countbase, np.int64)
    lay = lib.gt_pileup_layout(_p(cigar), _p(cigar_off), _p(rpos), _p(span), len(rpos),
                               start, end)
    try:
        n_cols = lib.gt_pileup_layout_cols(lay)
        major = np.empty(n_cols, np.int64)
        minor = np.empty(n_cols, np.int64)
        # int32 counts (bounded by coverage depth): half the fresh-page
        # faults of an int64 matrix a chunk
        matrix = np.zeros((n_cols, featlen * num_homop), np.int32)
        lib.gt_pileup_fill(lay, _p(seq), _p(qual), _p(seq_off), _p(cigar), _p(cigar_off),
                           _p(rpos), _p(rev), len(rpos), _p(tbl), del_fwd, del_rev, num_homop,
                           featlen, _p(major), _p(minor), _p(matrix))
    finally:
        lib.gt_pileup_layout_free(lay)
    return major, minor, matrix


SB_BLOCKS = 1 << 16  # the 32-byte layout's superblock stride (blocks); see fmsearch.cpp


def _sidecar(didx, suffix: str, shape):
    """The index's .npy sidecar (mmap'd) when it is newer than the npz and
    of the right shape, else None."""
    npz = getattr(didx, "_npz_path", None)
    if not npz:
        return None
    path = npz + suffix
    if os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(npz):
        m = np.load(path, mmap_mode="r")
        if m.shape == shape and m.dtype == np.uint32:
            return m
    return None


def _save_sidecar(didx, suffix: str, pack):
    npz = getattr(didx, "_npz_path", None)
    if npz:
        try:
            np.save(npz + suffix, pack)
        except OSError:
            pass  # a read-only index directory: keep the rows in memory


def _one_hot_halves(cp_occ):
    """(hi, lo) uint32 views of the one-hot words: hi holds block positions
    0..31, lo 32..63.  The words are little-endian int64, so each is its
    lo word followed by its hi word."""
    if sys.byteorder != "little":
        words = cp_occ[:, 4:].view(np.uint64)
        return ((words >> np.uint64(32)).astype(np.uint32),
                (words & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    v = np.ascontiguousarray(cp_occ).view(np.uint32)  # [blocks, 16]
    return v[:, 9:16:2], v[:, 8:16:2]


def hostpack32(didx):
    """The 32-byte occ layout of fmsearch.cpp's occ4 v2: [blocks, 8] uint32
    rows (the four counts relative to the superblock, then the two
    bit-plane words of each half block: hi plane = bases G/T, lo plane =
    bases C/T) and the [n_sb, 4] int64 superblock table.  Persisted as an
    mmap-able `<npz>.hostpack32.npy` sidecar; kept on the index object."""
    pack = getattr(didx, "_host_pack32", None)
    if pack is not None:
        return pack, didx._host_sb32
    occ = didx.cp_occ
    blocks = occ.shape[0]
    sb = np.ascontiguousarray(occ[::SB_BLOCKS, :4])
    pack = _sidecar(didx, ".hostpack32.npy", (blocks, 8))
    if pack is None:
        pack = np.empty((blocks, 8), np.uint32)
        # relative counts, a superblock at a time (no [blocks, 4] int64 temporary)
        for s0 in range(0, blocks, SB_BLOCKS):
            s1 = min(s0 + SB_BLOCKS, blocks)
            pack[s0:s1, 0:4] = (occ[s0:s1, :4] - sb[s0 // SB_BLOCKS]).astype(np.uint32)
        hi, lo = _one_hot_halves(occ)
        pack[:, 4] = hi[:, 2] | hi[:, 3]  # hi plane, positions 0..31
        pack[:, 5] = lo[:, 2] | lo[:, 3]  # hi plane, positions 32..63
        pack[:, 6] = hi[:, 1] | hi[:, 3]  # lo plane, positions 0..31
        pack[:, 7] = lo[:, 1] | lo[:, 3]  # lo plane, positions 32..63
        _save_sidecar(didx, ".hostpack32.npy", pack)
    didx._host_pack32, didx._host_sb32 = pack, sb
    return pack, sb


def hostpack64(didx):
    """The reference-shaped 64-byte occ rows (FMI_search.h:59-63 CP_OCC as
    fmsearch.cpp's v1 reads them): [blocks, 16] uint32, the counts' lo
    words, their hi words, the one-hot words' hi halves, their lo halves.
    Persisted as `<npz>.hostpack.npy`; kept on the index object."""
    pack = getattr(didx, "_host_pack", None)
    if pack is not None:
        return pack
    occ = didx.cp_occ
    blocks = occ.shape[0]
    pack = _sidecar(didx, ".hostpack.npy", (blocks, 16))
    if pack is None:
        pack = np.empty((blocks, 16), np.uint32)
        counts = np.ascontiguousarray(occ[:, :4])
        if sys.byteorder == "little":
            v = counts.view(np.uint32)  # [blocks, 8]: lo, hi of each count
            pack[:, 0:4] = v[:, 0::2]
            pack[:, 4:8] = v[:, 1::2]
        else:
            cnt = counts.astype(np.uint64)
            pack[:, 0:4] = (cnt & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            pack[:, 4:8] = (cnt >> np.uint64(32)).astype(np.uint32)
        pack[:, 8:12], pack[:, 12:16] = _one_hot_halves(occ)
        _save_sidecar(didx, ".hostpack.npy", pack)
    didx._host_pack = pack
    return pack


def _huge_copy(lib, didx, pack, attr):
    """Copy an occ table into an anonymous mapping advised for transparent
    huge pages (one per process): file-backed .npy mmaps sit on 4 KiB
    pages, and at genome scale every occ row is a dTLB miss and a page
    walk.  The copy is index loading, outside the search timer."""
    cached = getattr(didx, attr, None)
    if cached is not None and cached.shape == pack.shape:
        return cached
    ptr = lib.gt_alloc_pages(pack.nbytes, 1)
    if not ptr:
        return pack
    buf = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint32)),
                                shape=pack.shape)
    np.copyto(buf, pack)
    setattr(didx, attr, buf)
    return buf


def fmi_search_native(didx, enc_codes: np.ndarray, lengths: np.ndarray, min_seed_len: int = 19,
                      split_width: int = 10, max_mem_intv: int = 20, split_factor: float = 1.5,
                      threads: int | None = None, pack_mode: int | None = None):
    """Host 3-phase SMEM search over the packed index (native/fmsearch.cpp).

    didx: index.fmi_index.DeviceFmIndex; enc_codes: [B, L] int8/int32 codes
    (>= 4 ambiguous); lengths: [B].  Returns (smem dict of int64 arrays rid,
    m, n, k, l, s in phase order, n1, n2, n3).

    pack_mode 32 (default; GT_FMI_PACK overrides) searches the 32-byte
    bit-plane rows, 64 the reference-shaped rows.  The 32-byte table is
    copied onto huge pages past 1 GB; GT_FMI_HUGE=1 or 0 forces it on or
    off (for the 64-byte rows only =1 turns it on).  fmsearch.cpp reads
    GT_FMI_ENGINE (serial, interleaved) and GT_FMI_WIDTH itself."""
    lib = _lib()
    if threads is None:
        threads = max(os.cpu_count() or 1, 1)
    if pack_mode is None:
        pack_mode = int(os.environ.get("GT_FMI_PACK", "32"))
    huge_env = os.environ.get("GT_FMI_HUGE")
    if pack_mode == 32:
        pack, sb = hostpack32(didx)
        huge = pack.nbytes > (1 << 30) if huge_env is None else huge_env not in ("0", "")
        if huge:
            pack = _huge_copy(lib, didx, pack, "_host_pack32_huge")
    else:
        pack = hostpack64(didx)
        if huge_env not in (None, "0", ""):
            pack = _huge_copy(lib, didx, pack, "_host_pack_huge")
    pack = np.ascontiguousarray(pack)
    count5 = np.ascontiguousarray(didx.count, np.int64)

    b = enc_codes.shape[0]
    flat = np.ascontiguousarray(enc_codes.astype(np.int8).ravel())
    offs = np.arange(b, dtype=np.int64) * enc_codes.shape[1]
    lens = np.ascontiguousarray(lengths, np.int32)
    tail = (_p(flat), _p(offs), _p(lens), b, min_seed_len, split_width, max_mem_intv,
            split_factor, threads)
    if pack_mode == 32:
        h = lib.gt_fmi_run2(_p(pack), _p(sb), _p(count5), int(didx.sentinel_index), *tail)
    else:
        h = lib.gt_fmi_run(_p(pack), _p(count5), int(didx.sentinel_index), *tail)
    try:
        n1, n2, n3 = lib.gt_fmi_n1(h), lib.gt_fmi_n2(h), lib.gt_fmi_n3(h)
        keys = ("rid", "m", "n", "k", "l", "s")
        out = {key: np.empty(n1 + n2 + n3, np.int64) for key in keys}
        lib.gt_fmi_copy(h, *(_p(out[key]) for key in keys))
    finally:
        lib.gt_fmi_free(h)
    return out, int(n1), int(n2), int(n3)


def parse_reads_native(path: str, limit: int = -1):
    """FASTA/FASTQ (plain or gzip) straight to codes (native/fastio.cpp):
    (codes int8[total] (A0 C1 G2 T3 in either case, any other byte 4),
    quals int8[total] (phred, FASTQ only) or None, offsets int64[N],
    lengths int32[N]).  `limit` >= 0 reads that many records at most.
    Raises when the file cannot be read."""
    lib = _lib()
    h = lib.gt_parse_reads(os.fsencode(path), limit)
    if not h:
        raise OSError(f"native FASTA/FASTQ parse failed for {path}")
    try:
        n, total, nq = lib.gt_num_reads(h), lib.gt_total_bases(h), lib.gt_num_quals(h)
        codes = np.empty(total, np.int8)
        quals = np.empty(nq, np.int8) if nq else None
        offsets = np.empty(n, np.int64)
        lengths = np.empty(n, np.int32)
        lib.gt_copy_out(h, _p(codes), _p(quals) if nq else None, _p(offsets), _p(lengths))
    finally:
        lib.gt_free_reads(h)
    return codes, quals, offsets, lengths


def sub48_native(arr: np.ndarray):
    """int8(arr) - 48 in one native pass."""
    arr = np.ascontiguousarray(arr, np.uint8)
    out = np.empty(arr.size, np.int8)
    _lib().gt_sub48(_p(arr), arr.size, _p(out))
    return out


def parse_pairs_struct_native(buf: np.ndarray):
    """One-pass structural parse of the bsw 3-line pair format
    (native/pairsio.cpp): buf is the file's bytes (uint8); returns (t_off
    int64, t_len int32, q_off int64, q_len int32, h0 int32), offsets into
    buf."""
    lib = _lib()
    buf = np.ascontiguousarray(buf, np.uint8)
    n = lib.gt_pairs_count(_p(buf), buf.size)
    t_off, q_off = np.empty(n, np.int64), np.empty(n, np.int64)
    t_len, q_len, h0 = np.empty(n, np.int32), np.empty(n, np.int32), np.empty(n, np.int32)
    lib.gt_pairs_parse(_p(buf), buf.size, n, _p(t_off), _p(t_len), _p(q_off), _p(q_len),
                       _p(h0))
    return t_off, t_len, q_off, q_len, h0


def kmer_count_native(codes: np.ndarray, offs: np.ndarray, lens: np.ndarray, k: int,
                      min_len: int, saturation: int, log2_slots: int):
    """Flye's k-mer counter on the host (native/kmercnt.cpp): (total_kmers,
    hash_size, occurrences), or None when a table of 2^33 slots still
    fills past 90% or cannot be mapped (the JAX module's None; its caller
    then streams through the device accumulator).  Retries with a doubled
    table when the 90% load cap trips."""
    lib = _lib()
    codes = np.ascontiguousarray(codes, np.int8)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.zeros(3, np.int64)
    while log2_slots < 34:
        rc = lib.gt_kmer_count(_p(codes), _p(offs), _p(lens), len(lens), k, min_len, saturation,
                               log2_slots, _p(out[0:]), _p(out[1:]), _p(out[2:]))
        if rc == 0:
            return int(out[0]), int(out[1]), int(out[2])
        if rc != 1:  # rc 2: the table's mmap failed, a larger retry cannot help
            return None
        log2_slots += 1  # rc 1: the 90% load cap tripped, grow and retry
    return None


def read_bam_native(path: str):
    """Native BGZF and BAM decode of a whole file into columnar arrays:
    (refs [(name, length)], cols) where cols has ref_id, pos, mapq, flag
    (int32[N]); name_off/cigar_off/seq_off (int64[N+1] exclusive
    prefixes); names (bytes); cigar (uint32 raw words); seq_nt16, qual
    (uint8).  Raises when the file cannot be read."""
    lib = _lib()
    h = lib.gt_bam_open(os.fsencode(path))
    if not h:
        raise OSError(f"native BAM decode failed for {path}")
    try:
        n_refs = lib.gt_bam_n_refs(h)
        rn = ctypes.create_string_buffer(int(lib.gt_bam_refnames_bytes(h)))
        rlens = np.empty(n_refs, np.int64)
        lib.gt_bam_copy_refs(h, rn, _p(rlens))
        refs = list(zip(rn.raw.decode().split("\n")[:n_refs], rlens.tolist()))
        cols = _bam_cols(lib, h)
    finally:
        lib.gt_bam_free(h)
    return refs, cols


def detect_events_native(raw: np.ndarray):
    """Scrappie's event detection of one raw signal (native/events.cpp; its
    contract is ops.oracle.events.detect_events): the oracle's structured
    array (start, length, mean, stdv)."""
    lib = _lib()
    raw = np.ascontiguousarray(raw, np.float32)
    cap = max(len(raw), 16)
    start = np.empty(cap, np.uint64)
    length, mean, stdv = (np.empty(cap, np.float32) for _ in range(3))
    n = lib.gt_detect_events(_p(raw), len(raw), _p(start), _p(length), _p(mean), _p(stdv), cap)
    ev = np.zeros(n, dtype=[("start", np.uint64), ("length", np.float32),
                            ("mean", np.float32), ("stdv", np.float32)])
    ev["start"], ev["length"], ev["mean"], ev["stdv"] = start[:n], length[:n], mean[:n], stdv[:n]
    return ev


def abea_traceback_native(trace, bll_e, lv, ranks, events, model, scales, shifts, ne, nk, bw,
                          lp_trim):
    """The abea traceback and QC of a group of reads on the host
    (native/abea_tb.cpp, the JAX ops/abea._traceback's walk bit for bit).
    Returns per read its [(kmer_idx, event_idx)], or [] when QC drops it.

    trace: [G, nb_max, bw] uint8 (rows 0/1 seeded); bll_e: [G, nb_max]
    int64; lv: [G, nb_max-2] f64 (the last k-mer's cell of bands 2..);
    ranks: [G, nk_max] int32; events: [G, ne_max] f32; ne/nk: [G] int64."""
    lib = _lib()
    g_n, nb_max, bw_a = trace.shape
    if bw_a != bw:
        raise ValueError(f"trace planes are {bw_a} wide, not {bw}")
    trace = np.ascontiguousarray(trace, np.uint8)
    bll_e = np.ascontiguousarray(bll_e, np.int64)
    lv = np.ascontiguousarray(lv, np.float64)
    ranks = np.ascontiguousarray(ranks, np.int32)
    events = np.ascontiguousarray(events, np.float32)
    lm, ls, lls = (np.ascontiguousarray(model[k], np.float32)
                   for k in ("level_mean", "level_stdv", "level_log_stdv"))
    sc = np.ascontiguousarray(scales, np.float32)
    sh = np.ascontiguousarray(shifts, np.float32)
    ne = np.ascontiguousarray(ne, np.int64)
    nk = np.ascontiguousarray(nk, np.int64)
    cap = int(ne.max() + nk.max())
    out_pairs = np.empty((g_n, 2 * cap), np.int32)
    out_n = np.empty(g_n, np.int64)
    rc = lib.gt_abea_traceback(g_n, _p(trace), _p(bll_e), _p(lv), _p(ranks), _p(events), _p(lm),
                               _p(ls), _p(lls), _p(sc), _p(sh), _p(ne), _p(nk), nb_max, bw,
                               ranks.shape[1], events.shape[1], float(lp_trim), _p(out_pairs),
                               _p(out_n), cap)
    if rc != 0:
        raise RuntimeError(f"gt_abea_traceback failed rc={rc}")
    results = []
    for g in range(g_n):
        pr = out_pairs[g, : 2 * int(out_n[g])].reshape(-1, 2)
        results.append(list(zip(pr[:, 0].tolist(), pr[:, 1].tolist())))
    return results


def ctc_beam_native(log_probs, beam_size: int, threshold: float):
    """CTC prefix beam search (native/ctc_beam.cpp; its contract is the
    Python walk of models.bonito.beam_search_decode): the label list."""
    lib = _lib()
    lp = np.ascontiguousarray(log_probs, np.float32)
    t_len, n_class = lp.shape
    cap = t_len + 1
    out = np.empty(cap, np.int32)
    n = lib.gt_ctc_beam(_p(lp), t_len, n_class, beam_size, float(threshold), _p(out), cap)
    if n < 0:
        raise RuntimeError("gt_ctc_beam output overflow")
    return out[:n].tolist()


def minimizer_counts_native(reads_codes, k: int, window: int, min_read_length: int):
    """Flye's minimizer counts (native/minimizers.cpp; its contract is
    ops.oracle.kmer.yield_minimizers and a Counter of canonical codes).
    reads_codes: a list of uint8 2-bit code arrays.  Returns
    {canonical_code: count}."""
    lib = _lib()
    lengths = np.array([len(c) for c in reads_codes], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    flat = (np.concatenate(reads_codes).astype(np.uint8) if len(reads_codes)
            else np.zeros(0, np.uint8))
    h = lib.gt_minimizers_count(_p(flat), _p(offsets), _p(lengths), len(reads_codes), k, window,
                                min_read_length)
    try:
        n = lib.gt_minimizers_size(h)
        keys = np.empty(n, np.uint64)
        counts = np.empty(n, np.int64)
        lib.gt_minimizers_copy(h, _p(keys), _p(counts))
    finally:
        lib.gt_minimizers_free(h)
    return dict(zip(keys.tolist(), counts.tolist()))


def eventalign_realign_native(ref_codes, ref_offset, segments, rc, read_length, ev_mean, sc,
                              model, b2e, events_per_base):
    """f5c's eventalign realign of one read (native/eventalign.cpp; its
    contract is ops.oracle.eventalign.align_read_to_ref).  `segments` are
    the trimmed [(ref_pos, read_pos)] lists of the cigar walk.  Returns
    (ref_pos int32, event_idx int32, states bytes of b'M'/b'B')."""
    lib = _lib()
    ref_codes = np.ascontiguousarray(ref_codes, np.uint8)
    pair_ref = np.ascontiguousarray([p[0] for seg in segments for p in seg], np.int32)
    pair_read = np.ascontiguousarray([p[1] for seg in segments for p in seg], np.int32)
    seg_off = np.zeros(len(segments) + 1, np.int64)
    np.cumsum([len(s) for s in segments], out=seg_off[1:])
    ev_mean = np.ascontiguousarray(ev_mean, np.float32)
    lm, ls, lls = (np.ascontiguousarray(model[k], np.float32)
                   for k in ("level_mean", "level_stdv", "level_log_stdv"))
    b2e = np.ascontiguousarray(b2e, np.int32)
    cap = int(2 * len(ev_mean) + 1024)
    out_rp, out_ei = np.empty(cap, np.int32), np.empty(cap, np.int32)
    out_st = np.empty(cap, np.uint8)
    n = lib.gt_eventalign_realign(
        _p(ref_codes), len(ref_codes), int(ref_offset), _p(pair_ref), _p(pair_read),
        _p(seg_off), len(segments), 1 if rc else 0, int(read_length), _p(ev_mean), len(ev_mean),
        float(sc["shift"]), float(sc["scale"]), float(sc["var"]), float(sc["log_var"]),
        _p(lm), _p(ls), _p(lls), _p(b2e), len(b2e), float(events_per_base),
        _p(out_rp), _p(out_ei), _p(out_st), cap)
    if n < 0:
        raise RuntimeError("gt_eventalign_realign: output capacity exceeded")
    return out_rp[:n].copy(), out_ei[:n].copy(), out_st[:n].tobytes()


def eventalign_emit_native(rp, ei, kblob, mkblob, kmer_size, em, es, ed, mm, ms, sl, ref_name,
                           who):
    """A read's eventalign TSV rows as one str (native/eventalign.cpp
    gt_eventalign_emit: the f-string rows' bytes, -nan included)."""
    lib = _lib()
    n = int(rp.shape[0])
    rp = np.ascontiguousarray(rp, np.int32)
    ei = np.ascontiguousarray(ei, np.int32)
    cols = [np.ascontiguousarray(a, np.float64) for a in (em, es, ed, mm, ms, sl)]
    rn, wh = ref_name.encode(), who.encode()
    cap = n * (320 + 2 * kmer_size + len(rn) + len(wh)) + 4096
    out = np.empty(cap, np.uint8)
    wrote = lib.gt_eventalign_emit(n, _p(rp), _p(ei), kblob, mkblob, int(kmer_size),
                                   *(_p(a) for a in cols), rn, wh, _p(out), cap)
    if wrote < 0:
        raise RuntimeError("gt_eventalign_emit: output capacity exceeded")
    return out[:wrote].tobytes().decode()
