"""ctypes bindings over the port's own build of native/*.cpp.

The port's copy of genomicsbench_palisade_tpu/io/native.py for the entry
points its drivers run: `sais` (the index builder's suffix array),
`read_bam_region_native` (the `.bai`-bounded BAM decode),
`dbg_window_native` (the dbg driver's window engine), the three pileup
engines (`pileup_events_native`, `pileup_events_cols_native`,
`pileup_matrix_native`) and `fmi_search_native` (the fmi CLI's host
engine), with the JAX module's signatures and return values.

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
            "span": np.empty(n, np.int32),
        }
        names = ctypes.create_string_buffer(int(lib.gt_bam_names_bytes(h)))
        lib.gt_bam_copy_out(h, *(_p(cols[k]) for k in ("ref_id", "pos", "mapq", "flag",
                                                       "name_off")),
                            names, *(_p(cols[k]) for k in ("cigar_off", "cigar", "seq_off",
                                                           "seq_nt16", "qual")))
        lib.gt_bam_copy_span(h, _p(cols["span"]))
        cols["names"] = names.raw
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
