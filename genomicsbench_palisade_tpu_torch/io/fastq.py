"""FASTA/FASTQ reading (plain or gzip) and the fmi read encoding.

The port's own copy of genomicsbench_palisade_tpu/io/fastq.py (its
pure-Python reader).  Replaces the reference's kseq.h/bseq path
(tools/bwa-mem2/src/bwa.cpp:349 bseq_read_one_fasta_file).
`encode_reads` is the vectorised fmi encoding (fmi.cpp:141-177, the
oracle's `encode_read` a read).  `read_codes` is the fmi CLIs' read: the
native parser straight to those codes (`io.native.parse_reads_native`, the
JAX CLI's reader), or the Python reader and `encode_reads` as its plain
version.
"""

from __future__ import annotations

import gzip

import numpy as np

# fmi.cpp:141-177: A0 C1 G2 T3 in either case, any other byte 4
_FMI_CODE = np.full(256, 4, dtype=np.int8)
for _i, _ch in enumerate("ACGT"):
    _FMI_CODE[ord(_ch)] = _FMI_CODE[ord(_ch.lower())] = _i


def _open(path):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def read_sequences(path, limit: int | None = None, full_names: bool = False):
    """Yields (name, seq, qual_or_None) from FASTA or FASTQ.

    name is the first header token (kseq semantics); full_names=True keeps
    the whole header line (bntseq .ann stores the comment too)."""
    count = 0
    with _open(path) as f:
        line = f.readline()
        while line:
            line = line.strip()
            if not line:
                line = f.readline()
                continue
            if line.startswith(b">"):  # FASTA (multi-line sequences)
                name = (line[1:] if full_names
                        else line[1:].split()[0]).decode()
                seq_parts = []
                line = f.readline()
                while line and not line.startswith(b">") and not line.startswith(b"@"):
                    seq_parts.append(line.strip())
                    line = f.readline()
                yield name, b"".join(seq_parts).decode(), None
            elif line.startswith(b"@"):  # FASTQ (4-line records)
                name = line[1:].split()[0].decode()
                seq = f.readline().strip().decode()
                f.readline()  # +
                qual = f.readline().strip().decode()
                yield name, seq, qual
                line = f.readline()
            else:
                line = f.readline()
                continue
            count += 1
            if limit is not None and count >= limit:
                return


def read_all(path, limit: int | None = None):
    return list(read_sequences(path, limit))


def encode_reads(seqs):
    """(enc int8 [n, longest] padded with 4, lengths int32 [n]): each row
    equals the oracle's `encode_read` of its read."""
    lens = np.array([len(s) for s in seqs], np.int32)
    flat = _FMI_CODE[np.frombuffer("".join(seqs).encode("latin-1"), np.uint8)]
    return pad_codes(flat, np.cumsum(lens, dtype=np.int64) - lens, lens)


def pad_codes(flat, offsets, lengths):
    """(enc int8 [n, longest] padded with 4, lengths int32 [n]) of reads
    laid end to end in `flat` (int8 codes) at `offsets`."""
    lens = np.asarray(lengths, np.int32)
    width = int(lens.max()) if len(lens) else 0
    enc = np.full((len(lens), width), 4, np.int8)
    if len(lens):
        rows = np.repeat(np.arange(len(lens)), lens)
        starts = np.repeat(np.asarray(offsets, np.int64), lens)
        cols = np.arange(len(rows)) - np.repeat(np.cumsum(lens, dtype=np.int64) - lens, lens)
        enc[rows, cols] = flat[starts + cols]
    return enc, lens


def read_codes(path, limit: int | None = None, use_native: bool = True):
    """The reads of a FASTA/FASTQ file encoded for fmi: (enc int8 [n,
    longest] padded with 4, lengths int32 [n]).  `limit` (None or 0: all)
    caps the records.  By default the native parser reads the file;
    `use_native=False` is `read_sequences` and `encode_reads`."""
    if use_native:
        from .native import parse_reads_native

        flat, _quals, offsets, lengths = parse_reads_native(str(path), limit or -1)
        return pad_codes(flat, offsets, lengths)
    return encode_reads([s for _n, s, _q in read_sequences(path, limit=limit or None)])
