"""The port's GRM (io/plink.py, ops/grm.py, cli/grm.py) on the CPU, against
the JAX package, a float64 oracle and the plink2 goldens.

Tolerances: genotypes, --maf masks, frequencies and counts are exact
(integers, and float64 divisions of the same integers); the GRM is within
plink2's 2e-5 single-precision contract (`tests/test_grm_golden.py`) of the
JAX CPU result for HIGH, HIGHEST and "compensated" (both packages run the
same float32 and bf16-split arithmetic on the CPU; only the product's
summation order differs); DEFAULT, one bf16 pass, is held to the float64
oracle at 4e-3 (`DEFAULT_BOUND`: 1.27e-3 and 0.63e-3 measured on the two
inputs below, 0.41e-3 to 1.27e-3 over five seeded inputs of 300-4,000
variants; Z's bf16 rounding is 2^-9 relative).  The writers are byte-equal.
"""

import base64
import json
import pathlib
import warnings

import numpy as np
import pytest

from genomicsbench_palisade_tpu.cli import grm as jcli
from genomicsbench_palisade_tpu.io import plink as JP
from genomicsbench_palisade_tpu.ops import grm as JG
from genomicsbench_palisade_tpu_torch.cli import grm as cli
from genomicsbench_palisade_tpu_torch.io import plink as P
from genomicsbench_palisade_tpu_torch.ops import grm as G

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CPU = "cpu"
TOL = 2e-5
DEFAULT_BOUND = 4e-3


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURES / "grm_golden.json") as f:
        return json.load(f)["cases"]


def _geno(seed, m, n, p_miss=0.05):
    rng = np.random.default_rng(seed)
    geno = rng.choice([0, 1, 2], size=(m, n), p=[0.5, 0.3, 0.2]).astype(np.int8)
    geno[rng.random((m, n)) < p_miss] = 3
    geno[5] = 1  # all het: variance 0.5, kept
    geno[6] = 0  # monomorphic: degenerate, zeroed
    geno[7] = 3  # all missing
    geno[8, :] = 2
    geno[8, 0] = 0  # rare: af near 1, below a --maf 0.05
    return geno


def _grm_oracle(geno):
    """Direct per-pair GCTA GRM with missing exclusion, float64
    (tests/test_grm.py:9-27)."""
    m, n = geno.shape
    miss = geno == 3
    g = geno.astype(np.float64)
    g[miss] = np.nan
    with warnings.catch_warnings():  # the all-missing variant's mean is nan
        warnings.simplefilter("ignore", RuntimeWarning)
        freqs = np.nanmean(g, axis=1) / 2.0
    var = 2 * freqs * (1 - freqs)
    grm, cnt = np.zeros((n, n)), np.zeros((n, n))
    for i in range(m):
        if not var[i] > 2**-44:
            continue
        z = (g[i] - 2 * freqs[i]) / np.sqrt(var[i])
        ok = ~np.isnan(z)
        zz = np.where(ok, z, 0.0)
        grm += np.outer(zz, zz)
        cnt += np.outer(ok, ok)
    return grm / np.maximum(cnt, 1), cnt


def _case_files(case, tmp_path):
    paths = {ext: tmp_path / f"case.{ext}" for ext in ("pgen", "pvar", "psam")}
    paths["pgen"].write_bytes(base64.b64decode(case["pgen"]))
    paths["pvar"].write_text(case["pvar"])
    paths["psam"].write_text(case["psam"])
    return [str(paths[e]) for e in ("pgen", "pvar", "psam")]


def test_readers_equal_jax_on_goldens(golden, tmp_path):
    """read_pgen on the 25 plink2 .pgen files and read_bed on their
    genotypes as .bed: arrays and ids equal the JAX readers'."""
    for ci, case in enumerate(golden):
        files = _case_files(case, tmp_path)
        got, want = P.read_pgen(*files), JP.read_pgen(*files)
        np.testing.assert_array_equal(got[0], np.array(case["geno"], np.int8), err_msg=str(ci))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.int8 and got[1:] == want[1:]
        prefix = str(tmp_path / "case")
        JP.write_bed(prefix, got[0])
        got, want = P.read_bed(prefix), JP.read_bed(prefix)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_fixed_width_pgen_equals_jax(tmp_path):
    """Mode 0x02 (fixed-width 2-bit records), decoded in one pass."""
    rng = np.random.default_rng(3)
    m, n = 9, 13
    codes = rng.integers(0, 4, (m, n)).astype(np.uint8)
    padded = np.zeros((m, (n + 3) // 4 * 4), np.uint8)
    padded[:, :n] = codes
    packed = (padded[:, 0::4] | padded[:, 1::4] << 2 | padded[:, 2::4] << 4
              | padded[:, 3::4] << 6)
    path = tmp_path / "fixed.pgen"
    path.write_bytes(b"\x6c\x1b\x02" + m.to_bytes(4, "little") + n.to_bytes(4, "little")
                     + b"\x00" + packed.tobytes())
    got = P.read_pgen(str(path))[0]
    np.testing.assert_array_equal(got, JP.read_pgen(str(path))[0])
    np.testing.assert_array_equal(got, codes.astype(np.int8))


@pytest.mark.parametrize("n", [1, 4, 7, 13, 66])
def test_writers_byte_equal_to_jax(tmp_path, n):
    """write_bed (2-bit codes packed by shifts) and write_grm_bin (the lower
    triangle in one selection) write the JAX writers' bytes, for sample
    counts that are and are not a multiple of 4."""
    rng = np.random.default_rng(n)
    geno = rng.integers(0, 4, (23, n)).astype(np.int8)
    ids = [f"fam{j}\tind{j}" for j in range(n)]
    for name, mod in (("jax", JP), ("port", P)):
        mod.write_bed(str(tmp_path / name), geno)
        mod.write_bed(str(tmp_path / f"{name}_ids"), geno, sample_ids=ids,
                      variant_ids=[f"rs{i}" for i in range(23)])
    for stem in ("", "_ids"):
        for ext in (".bed", ".bim", ".fam"):
            assert ((tmp_path / f"port{stem}{ext}").read_bytes()
                    == (tmp_path / f"jax{stem}{ext}").read_bytes()), (stem, ext)
    np.testing.assert_array_equal(P.read_bed(str(tmp_path / "port"))[0], geno)
    grm = rng.normal(0, 1, (n, n)).astype(np.float32)
    counts = rng.integers(0, 30, (n, n)).astype(np.float32)
    sids = [f"F{j}\tI{j}" for j in range(n - 1)] + ["solo"]
    JG.write_grm_bin(str(tmp_path / "jax"), grm, counts, sids)
    G.write_grm_bin(str(tmp_path / "port"), grm, counts, sids)
    for ext in (".grm.bin", ".grm.N.bin", ".grm.id"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    with pytest.raises(ValueError, match="genotypes"):
        P.pack_bed(np.full((1, 2), 4, np.int8))


@pytest.mark.parametrize("maf", [0.0, 0.01, 0.05, 0.3])
def test_maf_filter_and_freqs_equal_jax(maf):
    geno = _geno(1, 400, 29)
    np.testing.assert_array_equal(G.maf_filter(geno, maf), JG.maf_filter(geno, maf))
    counts = G.allele_counts(geno)
    np.testing.assert_array_equal(G.maf_filter(geno, maf, counts), JG.maf_filter(geno, maf))
    # the frequencies compute_grm uses: the JAX float64 sums' numbers exactly
    np.testing.assert_array_equal(G.allele_freqs(*counts), JG.normalize_block_np(geno)[2])
    z, v, f = G.normalize_block_np(geno)
    jz, jv, jf = JG.normalize_block_np(geno)
    np.testing.assert_array_equal(z, jz)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def _jax_device(geno, block, precision):
    import jax

    freqs = JG.normalize_block_np(geno)[2]
    variance = 2.0 * freqs * (1.0 - freqs)
    ok = variance > JG.K_SMALL_EPSILON
    isd = np.zeros_like(variance)
    isd[ok] = 1.0 / np.sqrt(variance[ok])
    prec = {"HIGH": jax.lax.Precision.HIGH,
            "HIGHEST": jax.lax.Precision.HIGHEST}.get(precision, precision)
    sums, counts = JG._grm_device(geno, (2 * freqs).astype(np.float32),
                                  isd.astype(np.float32), ok, block=block, precision=prec)
    sums, counts = np.asarray(sums), np.asarray(counts)
    return sums / np.maximum(counts, 1.0), counts


@pytest.mark.parametrize("precision", ["HIGH", "HIGHEST", "compensated"])
@pytest.mark.parametrize("block", [128, 100])
def test_compute_grm_equals_jax(precision, block):
    """M = 1024: block 128 divides it, block 100 leaves a padded last
    block.  Counts exact; the GRM within 2e-5 of the JAX CPU result (the
    compensated split's bf16 roundings are real on both)."""
    geno = _geno(2, 1024, 48)
    want, want_cnt = _jax_device(geno, block, precision)
    got, got_cnt = G.compute_grm(geno, block=block, precision=precision, device=CPU)
    assert got.dtype == got_cnt.dtype == np.float32
    np.testing.assert_array_equal(got_cnt, want_cnt)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if precision == "HIGH":
        jgrm, jcnt = JG.compute_grm(geno, block=block)
        np.testing.assert_array_equal(got_cnt, jcnt)
        np.testing.assert_allclose(got, jgrm, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed,m,n", [(0, 300, 40), (4, 2048, 64)])
def test_default_precision_against_f64_oracle(seed, m, n):
    """DEFAULT (one bf16 pass) against the float64 oracle: counts exact,
    the GRM within DEFAULT_BOUND; the IEEE modes within 2e-5 of it."""
    geno = _geno(seed, m, n)
    want, want_cnt = _grm_oracle(geno)
    for precision in G.PRECISIONS:
        got, got_cnt = G.compute_grm(geno, block=256, precision=precision, device=CPU)
        np.testing.assert_array_equal(got_cnt, want_cnt)
        err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
        assert err < (DEFAULT_BOUND if precision == "DEFAULT" else TOL), (precision, err)
    with pytest.raises(ValueError, match="precision"):
        G.compute_grm(geno, precision="TF32", device=CPU)


def test_block_update_and_device_dtypes():
    """grm_block_update is one IEEE float32 step; grm_device's outputs are
    float32 (never bf16-typed), counts exact integers."""
    import torch

    z, v, _ = G.normalize_block_np(_geno(5, 64, 16))
    s0 = torch.zeros((16, 16))
    sums, counts = G.grm_block_update(s0, s0.clone(), torch.from_numpy(z), torch.from_numpy(v))
    js, jc = JG.grm_block_update(np.zeros((16, 16), np.float32), np.zeros((16, 16), np.float32),
                                 z, v)
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    geno = torch.from_numpy(_geno(5, 64, 16))
    ones = torch.ones(64)
    for precision in G.PRECISIONS:
        s, c = G.grm_device(geno, ones, ones, ones.bool(), 48, precision)
        assert s.dtype == c.dtype == torch.float32
        assert torch.equal(c, c.round())


def test_goldens_through_port(golden, tmp_path):
    """The 25 plink2 goldens: --maf removed counts, .grm.N.bin exact and
    .grm.bin within 2e-5, through read_pgen, maf_filter and compute_grm."""
    for ci, case in enumerate(golden):
        geno, sample_ids, _ = P.read_pgen(*_case_files(case, tmp_path))
        kept = G.maf_filter(geno, case["maf"])
        assert len(geno) - int(kept.sum()) == case["removed"], ci
        grm, counts = G.compute_grm(geno[kept], device=CPU)
        prefix = str(tmp_path / "out")
        G.write_grm_bin(prefix, grm, counts, sample_ids)
        np.testing.assert_array_equal(np.fromfile(prefix + ".grm.N.bin", "<f4"),
                                      np.array(case["n_bin"], np.float32), err_msg=str(ci))
        np.testing.assert_allclose(np.fromfile(prefix + ".grm.bin", "<f4"),
                                   np.array(case["grm_bin"], np.float32), atol=TOL, rtol=TOL,
                                   err_msg=str(ci))


def _cli_lines(out):
    return [ln.split(" (")[0] if ln.startswith("GRM written") else ln
            for ln in out.splitlines()]


@pytest.mark.parametrize("source", ["bfile", "pgen"])
def test_cli_equals_jax_cli(golden, tmp_path, capsys, monkeypatch, source):
    """The port's CLI writes .grm.N.bin and .grm.id byte-equal to the JAX
    CLI's, .grm.bin within 2e-5, and prints its lines (the timing aside)."""
    if source == "bfile":
        JP.write_bed(str(tmp_path / "in"), _geno(6, 700, 21))
        args = ["--bfile", str(tmp_path / "in")]
    else:
        files = _case_files(golden[3], tmp_path)
        args = ["--pgen", files[0], "--pvar", files[1], "--psam", files[2]]
    args += ["--maf", "0.01", "--make-grm-bin", "--threads", "1", "--block", "64"]
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out
    timings = {}
    assert cli.main(args + ["--out", str(tmp_path / "port"), "--device", CPU],
                    timings=timings) == 0
    got = capsys.readouterr().out
    assert _cli_lines(got) == [ln.replace("jax.grm", "port.grm") for ln in _cli_lines(want)]
    assert len(got.splitlines()) == 3 and "sec kernel)" in got.splitlines()[-1]
    for ext in (".grm.N.bin", ".grm.id"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    np.testing.assert_allclose(np.fromfile(tmp_path / "port.grm.bin", "<f4"),
                               np.fromfile(tmp_path / "jax.grm.bin", "<f4"), atol=TOL, rtol=TOL)
    assert {"read_s", "filter_s", "h2d_s", "products_s", "d2h_s", "write_s"} <= set(timings)
