"""Minimal BAM reader and writer (BGZF + BAM records, no htslib).

The port's own copy of genomicsbench_palisade_tpu/io/bam.py: whole-file
reads (`read_bam`), the streaming BGZF reader and `.bai` region queries
(`read_bam_region`, f5c's -w and htslib's sam_itr_querys), and the
writers (`write_bam`, `build_bai`).  As in the JAX module, a read that
asks for no tags decodes natively (native/bamio.cpp: `read_bam_native`,
and `read_bam_region_native` over the `.bai` window); the pure-Python
decoders read the tags, and stay as the plain version (`use_native=False`).

BAM spec: SAM v1 section 4.  BGZF = concatenated gzip members with a BSIZE
extra field; each inflates to <=64 KiB.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

FUNMAP = 0x4
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800
FREVERSE = 0x10

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"


def bgzf_decompress(data: bytes) -> bytes:
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError("bad BGZF magic")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        extra = data[pos + 12 : pos + 12 + xlen]
        bsize = None
        ep = 0
        while ep < len(extra):
            si1, si2, slen = extra[ep], extra[ep + 1], struct.unpack_from("<H", extra, ep + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, ep + 4)[0] + 1
            ep += 4 + slen
        if bsize is None:
            raise ValueError("not BGZF (no BC extra field)")
        cdata = data[pos + 12 + xlen : pos + bsize - 8]
        out.append(zlib.decompress(cdata, -15))
        pos += bsize
    return b"".join(out)


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int  # 0-based leftmost
    mapq: int
    cigar: list  # [(op_char, length)]
    seq_nt16: np.ndarray  # 4-bit codes per base
    qual: np.ndarray
    tags: dict

    @property
    def is_reverse(self):
        return bool(self.flag & FREVERSE)


def _parse_tags(buf: bytes) -> dict:
    tags = {}
    pos = 0
    n = len(buf)
    sizes = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
    fmts = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I", "f": "<f"}
    while pos + 3 <= n:
        tag = buf[pos : pos + 2].decode()
        typ = chr(buf[pos + 2])
        pos += 3
        if typ in sizes:
            tags[tag] = struct.unpack_from(fmts[typ], buf, pos)[0]
            pos += sizes[typ]
        elif typ == "A":
            tags[tag] = chr(buf[pos])
            pos += 1
        elif typ in ("Z", "H"):
            end = buf.index(0, pos)
            tags[tag] = buf[pos:end].decode()
            pos = end + 1
        elif typ == "B":
            sub = chr(buf[pos])
            cnt = struct.unpack_from("<I", buf, pos + 1)[0]
            pos += 5
            tags[tag] = np.frombuffer(buf[pos : pos + cnt * sizes[sub]], dtype=fmts[sub][1:]).copy()
            pos += cnt * sizes[sub]
        else:
            raise ValueError(f"unknown tag type {typ}")
    return tags


def _records_from_cols(cols) -> list:
    """BamRecords (no tags) of the native decoders' columnar arrays."""
    no, co, so = (cols[k].tolist() for k in ("name_off", "cigar_off", "seq_off"))
    names, seq, qual = cols["names"], cols["seq_nt16"], cols["qual"]
    ops = [CIGAR_OPS[c] for c in (cols["cigar"] & 0xF).tolist()]
    lens = (cols["cigar"] >> 4).tolist()
    return [BamRecord(names[no[i] : no[i + 1]].decode(), flag, ref_id, pos, mapq,
                      list(zip(ops[co[i] : co[i + 1]], lens[co[i] : co[i + 1]])),
                      seq[so[i] : so[i + 1]], qual[so[i] : so[i + 1]], {})
            for i, (flag, ref_id, pos, mapq) in enumerate(zip(
                cols["flag"].tolist(), cols["ref_id"].tolist(), cols["pos"].tolist(),
                cols["mapq"].tolist()))]


def read_bam(path, parse_tags: bool = False, use_native: bool = True):
    """Returns (references [(name, length)], list[BamRecord]).  Without
    tags the native decoder reads the file; `use_native=False` (or
    `parse_tags`) reads it in Python."""
    if use_native and not parse_tags:
        from .native import read_bam_native

        refs, cols = read_bam_native(path)
        return refs, _records_from_cols(cols)
    with open(path, "rb") as f:
        raw = f.read()
    data = bgzf_decompress(raw)
    assert data[:4] == b"BAM\x01", "bad BAM magic"
    pos = 4
    l_text = struct.unpack_from("<i", data, pos)[0]
    pos += 4 + l_text
    n_ref = struct.unpack_from("<i", data, pos)[0]
    pos += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, pos)[0]
        name = data[pos + 4 : pos + 4 + l_name - 1].decode()
        l_ref = struct.unpack_from("<i", data, pos + 4 + l_name)[0]
        refs.append((name, l_ref))
        pos += 8 + l_name

    records = []
    n = len(data)
    while pos + 4 <= n:
        block_size = struct.unpack_from("<i", data, pos)[0]
        start = pos + 4
        (
            ref_id,
            p0,
            l_read_name,
            mapq,
            _bin,
            n_cigar,
            flag,
            l_seq,
            _next_ref,
            _next_pos,
            _tlen,
        ) = struct.unpack_from("<iiBBHHHiiii", data, start)
        off = start + 32
        name = data[off : off + l_read_name - 1].decode()
        off += l_read_name
        cig_raw = np.frombuffer(data[off : off + 4 * n_cigar], dtype="<u4")
        cigar = [(CIGAR_OPS[c & 0xF], int(c >> 4)) for c in cig_raw]
        off += 4 * n_cigar
        nbytes = (l_seq + 1) // 2
        seq_packed = np.frombuffer(data[off : off + nbytes], dtype=np.uint8)
        seq = np.empty(l_seq, dtype=np.uint8)
        seq[0::2] = seq_packed[: (l_seq + 1) // 2] >> 4
        if l_seq > 1:
            seq[1::2] = seq_packed[: l_seq // 2] & 0xF
        off += nbytes
        qual = np.frombuffer(data[off : off + l_seq], dtype=np.uint8).copy()
        off += l_seq
        tags = _parse_tags(data[off : pos + 4 + block_size]) if parse_tags else {}
        records.append(
            BamRecord(name, flag, ref_id, p0, mapq, cigar, seq, qual, tags)
        )
        pos = start + block_size
    return refs, records


def bgzf_compress(data: bytes) -> bytes:
    """Minimal BGZF writer (single-member-per-64K blocks + EOF block)."""
    out = []
    for i in range(0, max(len(data), 1), 65000):
        chunk = data[i : i + 65000]
        comp = zlib.compress(chunk, 6)[2:-4]  # raw deflate
        crc = zlib.crc32(chunk) & 0xFFFFFFFF
        bsize = len(comp) + 25 + 1
        out.append(
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
            + comp
            + struct.pack("<II", crc, len(chunk))
        )
    # EOF marker block
    out.append(
        bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"
        )
    )
    return b"".join(out)


def _encode_tag(tag: str, val) -> bytes:
    """SAM aux tag encoding (subset: i, f, Z, A, and B numeric arrays)."""
    head = tag.encode()
    if isinstance(val, str):
        if len(val) == 1:
            return head + b"A" + val.encode()
        return head + b"Z" + val.encode() + b"\x00"
    if isinstance(val, (int, np.integer)):
        return head + b"i" + struct.pack("<i", int(val))
    if isinstance(val, (float, np.floating)):
        return head + b"f" + struct.pack("<f", float(val))
    arr = np.asarray(val)
    sub = {"int8": b"c", "uint8": b"C", "int16": b"s", "uint16": b"S",
           "int32": b"i", "uint32": b"I", "float32": b"f"}.get(str(arr.dtype))
    if sub is None:
        arr = arr.astype(np.float32)
        sub = b"f"
    return head + b"B" + sub + struct.pack("<I", len(arr)) + arr.tobytes()


def write_bam(path, refs, records):
    """Minimal BAM writer for tests/fixtures (incl. aux tags)."""
    body = [b"BAM\x01", struct.pack("<i", 0), struct.pack("<i", len(refs))]
    for name, length in refs:
        nb = name.encode() + b"\x00"
        body.append(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))
    op_idx = {c: i for i, c in enumerate(CIGAR_OPS)}
    nt16_idx = {c: i for i, c in enumerate(SEQ_NT16_STR)}
    for r in records:
        nb = r.name.encode() + b"\x00"
        cig = b"".join(
            struct.pack("<I", (length << 4) | op_idx[op]) for op, length in r.cigar
        )
        l_seq = len(r.seq_nt16)
        packed = np.zeros((l_seq + 1) // 2, np.uint8)
        codes = np.asarray(r.seq_nt16, np.uint8)
        packed |= codes[0::2] << 4
        packed[: l_seq // 2] |= codes[1::2]
        rec = struct.pack(
            "<iiBBHHHiiii",
            r.ref_id,
            r.pos,
            len(nb),
            r.mapq,
            0,
            len(r.cigar),
            r.flag,
            l_seq,
            -1,
            -1,
            0,
        )
        rec += nb + cig + packed.tobytes() + bytes(r.qual.astype(np.uint8))
        for tag, val in (r.tags or {}).items():
            rec += _encode_tag(tag, val)
        body.append(struct.pack("<i", len(rec)) + rec)
    with open(path, "wb") as f:
        f.write(bgzf_compress(b"".join(body)))


# ---------------------------------------------------------------------------
# Indexed region access (.bai) + streaming BGZF: region queries without
# inflating the whole file (the reference's htslib sam_itr_querys path,
# medaka_counts.c:330-340 / debruijn.cpp:1492-1499).
# ---------------------------------------------------------------------------


def bgzf_after_empty_blocks(path: str, coff_lo: int, coff_hi: int) -> list:
    """The file offset just past each empty BGZF block (no data; the EOF
    marker is one) that starts in [coff_lo, coff_hi), from the blocks'
    headers.  bgzf_compress ends every call with one, so a file written in
    runs (a header, then records a call at a time) holds one after each
    run."""
    out = []
    with open(path, "rb") as f:
        coff = coff_lo
        while coff < coff_hi:
            f.seek(coff)
            head = f.read(12)
            if len(head) < 12:
                break
            (xlen,) = struct.unpack_from("<H", head, 10)
            extra = f.read(xlen)
            bsize, e = 0, 0
            while e + 4 <= len(extra):
                (slen,) = struct.unpack_from("<H", extra, e + 2)
                if extra[e : e + 2] == b"BC" and slen == 2:
                    bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
                e += 4 + slen
            if not bsize:
                break
            f.seek(coff + bsize - 4)
            isize = f.read(4)
            if len(isize) < 4:
                break
            coff += bsize
            if struct.unpack("<I", isize)[0] == 0:
                out.append(coff)
    return out


class BgzfStream:
    """Streaming BGZF inflater with virtual-offset seek/tell.

    A BAM virtual offset packs (compressed block offset << 16 | offset
    within that block's inflated data).  Blocks are inflated one at a
    time, so a multi-GB BAM costs 64 KiB-scale buffers, not its inflated
    size.  `bounds` maps buffer positions back to their source block so
    tell_virtual() is exact even when a record spans blocks."""

    def __init__(self, f):
        self.f = f
        self.buf = b""
        self.buf_pos = 0
        self.next_coffset = 0
        self.bounds = []  # (start_in_buf, block_coffset)
        self.eof = False

    def seek_virtual(self, voffset: int):
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        self.f.seek(coffset)
        self.next_coffset = coffset
        self.buf = b""
        self.buf_pos = 0
        self.bounds = []
        self.eof = False
        self._fill()
        self.buf_pos = min(uoffset, len(self.buf))

    def tell_virtual(self) -> int:
        """Virtual offset of the next byte to be read."""
        block_start, coffset = 0, self.next_coffset
        for bs, co in reversed(self.bounds):
            if bs <= self.buf_pos:
                block_start, coffset = bs, co
                break
        return (coffset << 16) | (self.buf_pos - block_start)

    def _fill(self) -> bool:
        """Drop consumed whole blocks, inflate the next one onto the tail."""
        # trim: keep only from the block containing buf_pos onward
        keep_from = 0
        for bs, _co in self.bounds:
            if bs <= self.buf_pos:
                keep_from = bs
        if keep_from:
            self.buf = self.buf[keep_from:]
            self.buf_pos -= keep_from
            self.bounds = [(bs - keep_from, co) for bs, co in self.bounds
                           if bs - keep_from >= 0]
        head = self.f.read(18)
        if len(head) < 18:
            self.eof = True
            return False
        assert head[:2] == b"\x1f\x8b", "bad BGZF magic"
        xlen = struct.unpack_from("<H", head, 10)[0]
        extra = head[12:] + self.f.read(xlen - 6)
        bsize = None
        ep = 0
        while ep < len(extra):
            si1, si2, slen = extra[ep], extra[ep + 1], struct.unpack_from(
                "<H", extra, ep + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, ep + 4)[0] + 1
            ep += 4 + slen
        assert bsize is not None, "not BGZF (no BC extra field)"
        cdata = self.f.read(bsize - 12 - xlen - 8)
        self.f.read(8)  # crc32 + isize
        inflated = zlib.decompress(cdata, -15)
        self.bounds.append((len(self.buf), self.next_coffset))
        self.buf = self.buf + inflated
        self.next_coffset += bsize
        return True

    def read(self, n: int) -> bytes:
        while len(self.buf) - self.buf_pos < n and not self.eof:
            self._fill()
        out = self.buf[self.buf_pos : self.buf_pos + n]
        self.buf_pos += len(out)
        return out


def read_bai(path: str):
    """Parse a .bai index: per reference, ({bin: [(chunk_beg, chunk_end)
    virtual offsets]}, linear-index uint64 array of 16 KiB windows)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"BAI\x01", "bad BAI magic"
    pos = 4
    n_ref = struct.unpack_from("<i", data, pos)[0]
    pos += 4
    refs = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        bins = {}
        for _ in range(n_bin):
            bin_id, n_chunk = struct.unpack_from("<Ii", data, pos)
            pos += 8
            chunks = []
            for _ in range(n_chunk):
                beg, end = struct.unpack_from("<QQ", data, pos)
                pos += 16
                chunks.append((beg, end))
            bins[bin_id] = chunks
        n_intv = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        ioffsets = np.frombuffer(data, "<u8", n_intv, pos).copy()
        pos += 8 * n_intv
        refs.append((bins, ioffsets))
    return refs


def _reg2bins(beg: int, end: int):
    """SAM spec §5.3 five-level binning for [beg, end)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


def _cigar_ref_len(cigar) -> int:
    return sum(length for op, length in cigar if op in "MDN=X")


def _parse_record(data: bytes, parse_tags: bool):
    (ref_id, p0, l_read_name, mapq, _bin, n_cigar, flag, l_seq, _nr, _np,
     _tl) = struct.unpack_from("<iiBBHHHiiii", data)
    off = 32
    name = data[off : off + l_read_name - 1].decode()
    off += l_read_name
    cig_raw = np.frombuffer(data[off : off + 4 * n_cigar], dtype="<u4")
    cigar = [(CIGAR_OPS[c & 0xF], int(c >> 4)) for c in cig_raw]
    off += 4 * n_cigar
    nbytes = (l_seq + 1) // 2
    seq_packed = np.frombuffer(data[off : off + nbytes], dtype=np.uint8)
    seq = np.empty(l_seq, dtype=np.uint8)
    seq[0::2] = seq_packed[: (l_seq + 1) // 2] >> 4
    if l_seq > 1:
        seq[1::2] = seq_packed[: l_seq // 2] & 0xF
    off += nbytes
    qual = np.frombuffer(data[off : off + l_seq], dtype=np.uint8).copy()
    off += l_seq
    tags = _parse_tags(data[off:]) if parse_tags else {}
    return BamRecord(name, flag, ref_id, p0, mapq, cigar, seq, qual, tags)


def read_bam_header_stream(stream: BgzfStream):
    """Parse magic + header text + references from a stream."""
    assert stream.read(4) == b"BAM\x01", "bad BAM magic"
    (l_text,) = struct.unpack("<i", stream.read(4))
    stream.read(l_text)
    (n_ref,) = struct.unpack("<i", stream.read(4))
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", stream.read(4))
        name = stream.read(l_name)[:-1].decode()
        (l_ref,) = struct.unpack("<i", stream.read(4))
        refs.append((name, l_ref))
    return refs


def _read_bam_region_via_native(path, chrom, beg, end, index):
    """read_bam_region through the native region decoder (streaming BGZF
    from the .bai window, the record parse and overlap filter in C): the
    Python path's records."""
    from .native import read_bam_region_native

    with open(path, "rb") as f:
        refs = read_bam_header_stream(BgzfStream(f))
    names = [r[0] for r in refs]
    if chrom not in names:
        return refs, []
    ref_id = names.index(chrom)
    bins, ioffsets = index[ref_id]
    chunks = [c for b in _reg2bins(beg, end) for c in bins.get(b, [])]
    if not chunks:
        return refs, []
    min_off = min(c[0] for c in chunks)
    win = beg >> 14
    if win < len(ioffsets) and ioffsets[win] > 0:
        min_off = max(min_off, int(ioffsets[win]))
    max_off = max(c[1] for c in chunks)
    cols = read_bam_region_native(path, int(min_off), int(max_off), ref_id, beg, end)
    return refs, _records_from_cols(cols)


def read_bam_region(path: str, chrom: str, beg: int, end: int,
                    parse_tags: bool = False, bai_path: str | None = None,
                    index=None, use_native: bool = True):
    """Records overlapping [beg, end) on `chrom` via the .bai index.

    Streams BGZF blocks from the index lower bound and stops at the
    first record starting at or past `end` (coordinate-sorted BAMs),
    so memory and IO are proportional to the region, not the file.
    `index`: a preloaded read_bai() result — callers iterating many
    chunks of one BAM (cli/pileup) pass it to skip re-parsing the .bai
    per query.  Without tags the native decoder reads the window;
    `use_native=False` (or `parse_tags`) reads it in Python."""
    if index is None:
        if bai_path is None:
            bai_path = path + ".bai"
        index = read_bai(bai_path)
    if use_native and not parse_tags:
        return _read_bam_region_via_native(path, chrom, beg, end, index)
    with open(path, "rb") as f:
        stream = BgzfStream(f)
        refs = read_bam_header_stream(stream)
        names = [r[0] for r in refs]
        if chrom not in names:
            return refs, []
        ref_id = names.index(chrom)
        bins, ioffsets = index[ref_id]
        chunks = [c for b in _reg2bins(beg, end) for c in bins.get(b, [])]
        if not chunks:
            return refs, []
        min_off = min(c[0] for c in chunks)
        win = beg >> 14
        if win < len(ioffsets) and ioffsets[win] > 0:
            min_off = max(min_off, int(ioffsets[win]))
        max_off = max(c[1] for c in chunks)
        stream.seek_virtual(min_off)
        records = []
        while True:
            voff = stream.tell_virtual()
            head = stream.read(4)
            if len(head) < 4:
                break
            (block_size,) = struct.unpack("<i", head)
            body = stream.read(block_size)
            if len(body) < block_size:
                break
            rid, p0 = struct.unpack_from("<ii", body)
            if rid != ref_id or p0 >= end:
                if rid > ref_id or (rid == ref_id and p0 >= end) or rid < 0:
                    break
                continue
            rec = _parse_record(body, parse_tags)
            if rec.pos + max(_cigar_ref_len(rec.cigar), 1) > beg:
                records.append(rec)
            if voff > max_off:
                break
    return refs, records


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec §5.3 bin for [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def build_bai(bam_path: str, out_path: str | None = None) -> str:
    """Build a .bai for a coordinate-sorted BAM (htslib's sam_index_build
    analog): per-reference binning index + 16 KiB linear index."""
    if out_path is None:
        out_path = bam_path + ".bai"
    with open(bam_path, "rb") as f:
        stream = BgzfStream(f)
        refs = read_bam_header_stream(stream)
        per_ref = [({}, {}) for _ in refs]  # (bins, linear)
        while True:
            voff = stream.tell_virtual()
            head = stream.read(4)
            if len(head) < 4:
                break
            (block_size,) = struct.unpack("<i", head)
            body = stream.read(block_size)
            if len(body) < block_size:
                break
            rid, p0 = struct.unpack_from("<ii", body)
            voff_end = stream.tell_virtual()
            if rid < 0:
                continue
            rec = _parse_record(body, False)
            rend = p0 + max(_cigar_ref_len(rec.cigar), 1)
            bins, linear = per_ref[rid]
            b = _reg2bin(p0, rend)
            if bins.get(b) and bins[b][-1][1] == voff:
                bins[b][-1] = (bins[b][-1][0], voff_end)  # extend chunk
            else:
                bins.setdefault(b, []).append((voff, voff_end))
            for win in range(p0 >> 14, ((rend - 1) >> 14) + 1):
                if win not in linear or voff < linear[win]:
                    linear[win] = voff
    with open(out_path, "wb") as f:
        f.write(b"BAI\x01")
        f.write(struct.pack("<i", len(refs)))
        for bins, linear in per_ref:
            f.write(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                f.write(struct.pack("<Ii", b, len(bins[b])))
                for beg, end in bins[b]:
                    f.write(struct.pack("<QQ", beg, end))
            n_intv = (max(linear) + 1) if linear else 0
            f.write(struct.pack("<i", n_intv))
            filled = 0
            for win in range(n_intv):
                filled = linear.get(win, filled)
                f.write(struct.pack("<Q", filled))
    return out_path
