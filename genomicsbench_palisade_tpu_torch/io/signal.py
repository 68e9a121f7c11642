"""Nanopore raw-signal + pore-model input (abea capability, f5c L1).

The port's own copy of genomicsbench_palisade_tpu/io/signal.py.

The reference reads raw signals from fast5 (HDF5) via fast5lite
(benchmarks/abea/src/fast5lite.h) and carries a compiled-in r9.4 pore
model table (benchmarks/abea/src/model.h).  Here the pore model is
loaded from the public nanopolish/f5c TSV format (columns
`kmer level_mean level_stdv [sd_mean sd_stdv weight]`), signals from
either `.npz` archives (name -> float32 raw) or fast5 when h5py is
available.  ADC -> pA conversion: (raw + offset) * range / digitisation
(fast5lite.h semantics).
"""

from __future__ import annotations

import numpy as np

from ..ops.oracle.abea import KMER_SIZE, get_kmer_rank


def load_pore_model(path, k: int = KMER_SIZE):
    """Parse a nanopolish/f5c model TSV into rank-indexed arrays."""
    n = 4 ** k
    level_mean = np.zeros(n, dtype=np.float32)
    level_stdv = np.ones(n, dtype=np.float32)
    seen = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t") if "\t" in line else line.split()
            if parts[0] == "kmer":  # header row
                continue
            kmer = parts[0]
            if len(kmer) != k:
                raise ValueError(f"model k-mer length {len(kmer)} != {k}")
            r = get_kmer_rank(kmer)
            level_mean[r] = np.float32(parts[1])
            level_stdv[r] = np.float32(parts[2])
            seen += 1
    if seen != n:
        raise ValueError(f"model has {seen} k-mers, expected {n}")
    return {
        "level_mean": level_mean,
        "level_stdv": level_stdv,
        "level_log_stdv": np.log(
            level_stdv.astype(np.float64)).astype(np.float32),  # C: (float)log((double)stdv)
    }


def load_signals_npz(path):
    """npz archive of name -> raw signal (already in pA)."""
    data = np.load(path)
    return {name: np.asarray(data[name], dtype=np.float32) for name in data.files}


def load_signals_fast5(path):
    """Multi- or single-read fast5 -> {read_id: signal_pA}. Needs h5py."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        def convert(raw_grp, ch_grp, read_id):
            sig = np.asarray(raw_grp["Signal"], dtype=np.float32)
            dig = np.float32(ch_grp.attrs["digitisation"])
            off = np.float32(ch_grp.attrs["offset"])
            rng = np.float32(ch_grp.attrs["range"])
            out[read_id] = (sig + off) * rng / dig

        if "Raw" in f:  # single-read layout
            reads = f["Raw/Reads"]
            for rname in reads:
                rid = reads[rname].attrs.get("read_id", rname)
                rid = rid.decode() if isinstance(rid, bytes) else str(rid)
                convert(reads[rname], f["UniqueGlobalKey/channel_id"], rid)
        else:  # multi-read layout: top-level read_<uuid> groups
            for gname in f:
                grp = f[gname]
                if "Raw" not in grp:
                    continue
                rid = gname[5:] if gname.startswith("read_") else gname
                convert(grp["Raw"], grp["channel_id"], rid)
    return out
