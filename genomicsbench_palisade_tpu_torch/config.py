"""Flye's key=value configuration files.

The port's own copy of `load_flye_cfg` from
genomicsbench_palisade_tpu/config.py (the port imports nothing of the JAX
package).  The reference's kmer-cnt driver reads its k-mer size, the
minimizer switch and window from such a file (kmer_cnt.cpp:179
Config::load).
"""

from __future__ import annotations


def load_flye_cfg(path: str) -> dict:
    """Parse the Flye key=value config format (supports 'key = value' and
    continuation-free lines; comments start with ';' or '#').  A value is
    an int if it parses as one, else a float, else the string."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split(";")[0].split("#")[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            val = val.strip()
            try:
                out[key.strip()] = int(val)
            except ValueError:
                try:
                    out[key.strip()] = float(val)
                except ValueError:
                    out[key.strip()] = val
    return out
