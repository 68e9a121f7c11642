"""FASTA/FASTQ reading (plain or gzip).

The port's own copy of genomicsbench_palisade_tpu/io/fastq.py (its
pure-Python reader).  Replaces the reference's kseq.h/bseq path
(tools/bwa-mem2/src/bwa.cpp:349 bseq_read_one_fasta_file).
"""

from __future__ import annotations

import gzip


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
