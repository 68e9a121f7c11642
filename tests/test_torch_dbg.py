"""The port's dbg slice on the CPU (ops/dbg.py, cli/dbg.py and the native
window engine io/native.dbg_window_native): the reference-binary goldens
(fixtures/dbg_golden.json, as tests/test_dbg_golden.py holds the JAX
package), the native window against the Python window on seeded fuzz
windows, and the port's CLI against the JAX CLI (which runs its Python
path here: native/ is not built) on a seeded BAM and FASTA.  Exact: the
outputs are graphs, counts and strings."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from genomicsbench_palisade_tpu.cli import dbg as jcli
from genomicsbench_palisade_tpu.ops import dbg as JD
from genomicsbench_palisade_tpu_torch.cli import dbg as cli
from genomicsbench_palisade_tpu_torch.io import bam
from genomicsbench_palisade_tpu_torch.io.native import dbg_window_native
from genomicsbench_palisade_tpu_torch.ops import dbg as D

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def golden():
    return json.loads((REPO / "tests" / "fixtures" / "dbg_golden.json").read_text())["cases"]


def _graph(case):
    g = D.DeBruijnGraph(case["kmer_size"])
    g.load_reference(case["ref"], case["ref_start"])
    for r in case["reads"]:
        g.load_read(r["seq"], np.array(r["quals"], np.uint8), case["min_qual"])
    return g


def test_graph_matches_reference_golden(golden):
    for case in golden:
        g = _graph(case)
        assert {k: [n.colours, n.position, float(n.weight)] for k, n in g.nodes.items()} \
            == case["nodes"]
        assert {f"{k}>{k2}": float(w) for k, n in g.nodes.items()
                for k2, w in n.edges.items()} == case["edges"]
        assert int(g.detect_cycles(2 * case["min_qual"])) == case["cycles"]


def test_variant_paths_match_reference_golden(golden):
    assert any(c["seeds"] for c in golden)
    for case in golden:
        g = _graph(case)
        min_weight = 2 * case["min_qual"]
        seeds = {(k, succ) for k, n in g.nodes.items() if n.colours == D.REF_AND_READ
                 for succ, w in n.edges.items()
                 if w >= min_weight or g.nodes[succ].colours in (D.REF_AND_READ, D.REF)}
        assert seeds == {(s["start"], s["succ"]) for s in case["seeds"]}
        for s in case["seeds"]:
            got = g.variant_paths_from_seed([s["start"], s["succ"]], min_weight)
            assert got == (None if s["exploded"] else s["paths"]), (s["start"], s["succ"])


def _fuzz_window(rng):
    ln = int(rng.integers(120, 500))
    ref = "".join(rng.choice(list("ACGTN"), p=[.24, .24, .24, .24, .04], size=ln))
    reads = []
    for _ in range(int(rng.integers(2, 20))):
        s = int(rng.integers(0, max(ln - 60, 1)))
        seq = list(ref[s : s + 60].replace("N", "A"))
        for pos in np.nonzero(rng.random(len(seq)) < 0.05)[0]:
            seq[pos] = "ACGTN"[rng.integers(0, 5)]
        reads.append(("".join(seq), rng.integers(5, 41, len(seq)).astype(np.uint8),
                      0x200 if rng.random() < 0.1 else 0))
    return ref, reads


@pytest.mark.parametrize("seed", [5, 6])
def test_native_window_equals_python_and_jax(seed):
    """native/dbg.cpp vs the port's and the JAX assemble_window on fuzzed
    windows (Ns, noise, QC-fail flags), bubble sequences verbatim."""
    rng = np.random.default_rng(seed)
    for t in range(8):
        ref, reads = _fuzz_window(rng)
        g, bubbles = D.assemble_window(ref, 3, reads, kmer_size=15, min_qual=20, min_reads=2)
        jg, jbubbles = JD.assemble_window(ref, 3, reads, kmer_size=15, min_qual=20, min_reads=2)
        want = (len(g.nodes), [D.path_sequence(p, 15) for p in bubbles])
        assert want == (len(jg.nodes), [JD.path_sequence(p, 15) for p in jbubbles]), t
        assert dbg_window_native(ref, 3, reads, 15, 20, 2) == want, t


def test_small_graph_rules_equal_jax():
    """The JAX package's unit cases (tests/test_dbg.py) through both."""
    for mod in (D, JD):
        g = mod.DeBruijnGraph(5)
        g.load_reference("ACGTTGCAAGGCATCCA", 100)
        assert sum(len(n.edges) for n in g.nodes.values()) == 17 - 5 - 1
        assert not g.detect_cycles()
        g = mod.DeBruijnGraph(3)
        g.load_reference("ACGACGACGACG", 0)
        assert g.detect_cycles()
    assert D.window_batches(0, 3000) == JD.window_batches(0, 3000)
    assert D.window_batches(17, 123_456, 900) == JD.window_batches(17, 123_456, 900)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    tmp = tmp_path_factory.mktemp("dbg")
    chip_smoke.write_dbg_dataset(tmp, 4000, np.random.default_rng(11), bam, coverage=12)
    return tmp


@pytest.mark.parametrize("region", ["chr1:1-4000", "chr1:700-3100", "chr1"])
@pytest.mark.parametrize("indexed", [True, False])
def test_cli_prints_the_jax_clis_lines(dataset, tmp_path, capsys, monkeypatch, region, indexed):
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    bam_path = dataset / "reads.bam"
    if not indexed:
        (tmp_path / "reads.bam").write_bytes(bam_path.read_bytes())
        bam_path = tmp_path / "reads.bam"
    args = [str(bam_path), region, str(dataset / "chr1.fa"), "4"]
    assert cli.main(args) == 0
    out = capsys.readouterr()
    assert jcli.main(args) == 0
    jout = capsys.readouterr()
    assert out.out == jout.out and out.out.startswith("Found ")
    assert out.err.startswith("Time in kernel: ") and jout.err.startswith("Time in kernel: ")
    n_windows, nodes, bubbles = (int(v) for v in out.out.replace(",", " ").split()
                                 if v.isdigit())
    assert n_windows > 1 and nodes > 0 and bubbles > 0


def test_assemble_engines_agree_on_the_dataset(dataset):
    ref = (dataset / "chr1.fa").read_text().split("\n")[1]
    reads = cli.region_reads(str(dataset / "reads.bam"), "chr1", 0, len(ref))
    stats = {}
    native = cli.assemble(ref, reads, 0, len(ref), stats=stats)
    assert native == cli.assemble(ref, reads, 0, len(ref), engine="python")
    assert stats["assemble_s"] > 0 and native[0] == len(D.window_batches(0, len(ref)))
    with pytest.raises(ValueError, match="unknown dbg engine"):
        cli.assemble(ref, reads, 0, len(ref), engine="gpu")
