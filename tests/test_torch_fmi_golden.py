"""Reference-binary goldens for the port's FM index and SMEM pipeline, on
the CPU: all 25 cases of fixtures/fmi_golden.json (the reference suite's
own FMI_search, tools/golden/fmi_harness.cpp) through the port alone.

Every case holds, exactly: the index build (ref_len, count[5], sentinel,
FNV-64 hashes of the CP_OCC records and of the compressed SA arrays); the
per-batch phase counts; the full sorted SMEM dump (rid, m, n, k, l, s),
its order on the reference's qsort key (rid, m, -n) and its payload as a
multiset (the reference's qsort is unstable in ties).  In a file of its
own, so that parallel test workers give it a worker.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch.convert import fmi_index_from_numpy
from genomicsbench_palisade_tpu_torch.index.builder import build_arrays
from genomicsbench_palisade_tpu_torch.io.fastq import encode_reads
from genomicsbench_palisade_tpu_torch.ops import fmi_pipeline as FP

FIXTURES = Path(__file__).parent / "fixtures"
_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fnv64(h, data: bytes) -> int:
    arr = np.frombuffer(data, np.uint8)
    for byte in arr.tolist():
        h ^= byte
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def index_hashes(idx):
    """FNV-64 of the CP_OCC records (the port's cp_occ rows as they are)
    and of sa_ms_byte then sa_ls_word."""
    hcp = _fnv64(14695981039346656037, np.ascontiguousarray(idx.cp_occ).tobytes())
    hsa = _fnv64(14695981039346656037, idx.sa_ms_byte.tobytes())
    return hcp, _fnv64(hsa, idx.sa_ls_word.tobytes())


def test_fmi_reference_golden_on_port():
    cases = json.loads((FIXTURES / "fmi_golden.json").read_text())["cases"]
    assert len(cases) == 25
    for ci, case in enumerate(cases):
        genome = np.array([_CODE[c] for c in case["seq"]], np.uint8)
        arrays = build_arrays(genome, sa_compression=True, device="cpu")
        assert arrays.ref_seq_len == case["ref_len"], ci
        assert arrays.count.tolist() == case["count"], ci
        assert arrays.sentinel_index == case["sentinel_index"], ci
        hcp, hsa = index_hashes(arrays)
        assert (f"{hcp:016x}", f"{hsa:016x}") == (case["hash_cp"], case["hash_sa"]), ci

        index = fmi_index_from_numpy(arrays, "cpu")
        reads, batch = case["reads"], case["batch"]
        got_counts, got = [], []
        for start in range(0, len(reads), batch):
            enc, rl = encode_reads(reads[start : start + batch])
            out, n1, n2, n3, ovf = FP.fmi_pipeline_batch(
                index, enc, rl, min_seed_len=case["min_seed_len"], rid_base=start)
            assert not ovf, ci
            got_counts.append([n1, n2, n3])
            got.extend(zip(*(out[k].tolist() for k in ("rid", "m", "n", "k", "l", "s"))))
        assert got_counts == case["batch_counts"], ci
        want = [tuple(s) for s in case["smems"]]
        assert len(got) == case["total"], ci
        assert [g[:3] for g in got] == [w[:3] for w in want], ci
        assert sorted(got) == sorted(want), ci
