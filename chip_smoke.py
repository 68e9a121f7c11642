#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's PairHMM path on one GPU and hold its
kernels to their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result):
  1. environment: Python, torch, CUDA, nvcc and the card (nvidia-smi);
  2. build csrc/phmm_forward.cu with nvcc (timed; ptxas register lines);
  3. the f32 kernel against the plain version on the card, bit for bit, at
     bench.py's shapes 8192x(250x302) and 4096x(250x473), with kernel and
     plain times (CUDA events), GCUPS and the bound;
  4. the main path: `cli.phmm.run_testcases` over a testfile written from
     --seed in the shape of the reference benchmark's dataset (550 batches of
     <=110 reads x <=37 haps), launch counts reset just before and read
     just after; phase split, end-to-end GCUPS (parse plus the median of
     three runs), fallback fraction; the run once more under torch.profiler
     for the device's busy share and time by kind; the CLI's printed lines
     against the pooled results; then every raw output of the counted run,
     f32 and f64, bucket by bucket, against the plain version on the same
     device tensors, the kernels timed on the main path's largest buckets,
     and 16 seeded testcases against the port's oracle (exactly);
  5. a `kernels` JSON line, the card's name and power limit, and the last
     line {"ok": true, "device": {...}}.
Every measurement is printed as it is taken.  Needs one CUDA card; without
one it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): f32 and f64 outside
# the tensor cores count an FMA as two operations; the kernel does none.
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 12  # 8 multiplies + 4 adds (csrc/phmm_forward.cu)
SOURCE = "genomicsbench_palisade_tpu_torch/csrc/phmm_forward.cu"
REPLACES = "genomicsbench_palisade_tpu/ops/phmm_pallas.py:38"


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------- data


def synth_bench_cases(rng, b, rl, hl):
    """bench.py:_synth_phmm_batch: reads are noisy (5%) substrings of their
    hap, quals 36-59."""
    reads, haps, pairs = [], [], []
    for i in range(b):
        hap = rng.integers(0, 4, hl)
        start = rng.integers(0, hl - rl)
        read = hap[start : start + rl].copy()
        noise = rng.random(rl) < 0.05
        read[noise] = rng.integers(0, 4, int(noise.sum()))
        reads.append({"bases": read, "q": rng.integers(36, 60, rl),
                      "i": rng.integers(36, 60, rl), "d": rng.integers(36, 60, rl),
                      "c": rng.integers(36, 60, rl)})
        haps.append(hap)
        pairs.append((i, i))
    return reads, haps, pairs


def qual33(arr) -> str:
    return "".join(chr(int(v) + 33) for v in arr)


N_BATCHES = 550  # the reference benchmark's dataset


def synth_testfile(path, rng, n_batches=N_BATCHES, max_reads=110, max_haps=37,
                   read_len=(10, 151), hap_len=(50, 473)):
    """The reference benchmark's dataset shape (the generator of
    tools/phmm_scale_bench.py): reads 10-151 bp, haps 50-473 bp, 60% of
    reads sampled from a hap with 3% mutations, q 6-40, i/d 30-45, c 10."""
    with open(path, "w") as f:
        for _ in range(n_batches):
            nr = int(rng.integers(1, max_reads + 1))
            nh = int(rng.integers(1, max_haps + 1))
            f.write(f"{nr} {nh}\n")
            haps = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(
                hap_len[0], hap_len[1] + 1)))) for _ in range(nh)]
            for _ in range(nr):
                rl = int(rng.integers(read_len[0], read_len[1] + 1))
                if rng.random() < 0.6 and len(haps[0]) > rl:
                    hp = haps[int(rng.integers(nh))]
                    if len(hp) > rl:
                        s = int(rng.integers(0, len(hp) - rl))
                        bases = list(hp[s : s + rl])
                        for p in np.nonzero(rng.random(rl) < 0.03)[0]:
                            bases[p] = "ACGT"[int(rng.integers(4))]
                        bases = "".join(bases)
                    else:
                        bases = hp
                        rl = len(bases)
                else:
                    bases = "".join("ACGT"[c] for c in rng.integers(0, 4, rl))
                f.write(f"{bases} {qual33(rng.integers(6, 41, rl))} "
                        f"{qual33(rng.integers(30, 46, rl))} "
                        f"{qual33(rng.integers(30, 46, rl))} {qual33(np.full(rl, 10))}\n")
            for hp in haps:
                f.write(hp + "\n")


# ---------------------------------------------------------------- measures


def cells_of(batch_np) -> int:
    return int(np.sum(batch_np["rslen"].astype(np.int64) * batch_np["haplen"]))


def bound(batch_np, itemsize: int, ops_per_s: float, table_elems: int):
    """Least time for the function on these inputs: the larger of the bytes
    it must move (each input once, the output once) over HBM bandwidth and
    its operations (12 per real cell) over the peak rate."""
    b, rp = batch_np["rs_row"].shape
    hp = batch_np["hap"].shape[1]
    nbytes = 5 * b * rp + b * hp + 8 * b + itemsize * (hp + 1 + table_elems) + itemsize * b
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_CELL * cells_of(batch_np) / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps: int):
    """Best of `reps` single calls, CUDA events; returns (ms, last result)."""
    best, out = math.inf, None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


def max_abs_diff(torch, a, b) -> float:
    """Max |a-b|; a NaN or inf where the other has another value is inf."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    d = (a - b).abs()[~same]
    return float(d.max()) if bool(torch.isfinite(d).all()) else math.inf


def device_profile(torch, fn) -> dict:
    """Run fn under torch.profiler; device seconds by kind and the share
    of the wall time the device was busy (union of its intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, kinds = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        name = e.name
        kind = ("phmm_forward_f32" if "phmm_forward_kernel<float" in name else
                "phmm_forward_f64" if "phmm_forward_kernel<double" in name else
                "memcpy_htod" if "HtoD" in name else
                "memcpy_dtoh" if "DtoH" in name else "other")
        kinds[kind] = kinds.get(kind, 0.0) + (end - start) * 1e-6
    if not spans:
        return {"wall_s": wall, "device": "not measured (the profiler saw no device events)"}
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) * 1e-6
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_s_by_kind": kinds, "device_events": len(spans)}


def compare(torch, P, batch_np, dtype, kernel_reps=3, plain_reps=2):
    """Kernel and plain version on the same tensors on the card."""
    tb = P.as_device_batch(batch_np, "cuda")
    P.forward_raw(tb, dtype)  # warm-up: first launch, table upload
    ms, got = time_ms(torch, lambda: P.forward_raw(tb, dtype), kernel_reps)
    plain_ms, want = time_ms(torch, lambda: P.phmm_forward_plain(tb, dtype), plain_reps)
    return ms, plain_ms, max_abs_diff(torch, got, want)


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from genomicsbench_palisade_tpu_torch.cli import phmm as cli
        from genomicsbench_palisade_tpu_torch.io.phmm_batch import parse_testfile
        from genomicsbench_palisade_tpu_torch.ops import phmm as P
        from genomicsbench_palisade_tpu_torch.ops import phmm_cuda
        from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as oracle
        from genomicsbench_palisade_tpu_torch.utils import build
    except ImportError as e:
        fail(f"the port is not importable ({e}); run from the repository root")
    log(f"seed {args.seed}")

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi = smi[0].strip() if smi else "nvidia-smi gave nothing"
    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
    env = {"python": sys.version.split()[0], "torch": torch.__version__,
           "torch_cuda": torch.version.cuda, "nvcc": nvcc_ver[-1] if nvcc_ver else "",
           "device": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count(), "nvidia_smi": smi}
    log("env " + json.dumps(env))

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build(phmm_cuda.SOURCE)
    build.load(phmm_cuda.SOURCE)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"build {lib_path.name}: {build_s:.2f} s")
    for ln in ptxas:
        log(f"  ptxas {ln}")

    kern = {"phmm_forward_f32": {"max_abs_err": 0.0}, "phmm_forward_f64": {"max_abs_err": 0.0}}

    def check(name, err, where):
        """Tolerance 0: kernel and plain version round the same ops alike."""
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)
        if err != 0.0:
            fail(f"{name} differs from its plain version at {where}: {err}")

    n_tables = sum(P.tables(np.float32)[k].size for k in ("ph2pr", "one_m_ph2pr",
                                                        "ph2pr_div3", "m2m"))

    # 3. f32 kernel vs plain version at bench.py's shapes
    rng = np.random.default_rng(args.seed)
    for b, rl, hl, r_pad, h_pad in ((8192, 250, 302, 256, 320), (4096, 250, 473, 256, 512)):
        reads, haps, pairs = synth_bench_cases(rng, b, rl, hl)
        batch_np = P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)
        ms, plain_ms, err = compare(torch, P, batch_np, torch.float32)
        bms, by = bound(batch_np, 4, F32_OPS_PER_S, n_tables)
        row = {"shape": f"{b}x({rl}x{hl}) bucket {r_pad}x{h_pad}", "ms": ms,
               "plain_ms": plain_ms, "max_abs_err": err,
               "gcups": cells_of(batch_np) / (ms * 1e-3) / 1e9,
               "bound_ms": bms, "bound_by": by}
        log("f32 kernel vs plain " + json.dumps(row))
        check("phmm_forward_f32", err, row["shape"])

    # 4. the main path at the dataset shape
    with tempfile.TemporaryDirectory() as tmp:
        tf = Path(tmp) / "testfile.txt"
        t0 = time.perf_counter()
        synth_testfile(tf, np.random.default_rng(args.seed))
        log(f"testfile: {N_BATCHES} batches, {tf.stat().st_size / 1e6:.1f} MB, "
            f"written in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        batches = parse_testfile(tf)
        parse_s = time.perf_counter() - t0
        reads, haps, pairs = [], [], []
        for bt in batches:
            r0, h0 = len(reads), len(haps)
            reads.extend(bt.reads)
            haps.extend(bt.haps)
            pairs.extend((r0 + r, h0 + h) for r, h in bt.pairs)
        cells = sum(len(reads[r]["bases"]) * len(haps[h]) for r, h in pairs)

        # counts go to 0 just before the main path and are read just after;
        # two more runs give the spread of its wall time
        stats: dict = {}
        kept: list = []  # per bucket: the tensors each pass was given, its raw outputs
        for k in phmm_cuda.KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = cli.run_testcases(reads, haps, pairs, device="cuda", stats=stats, keep=kept)
        run_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in phmm_cuda.KERNELS.values()}
        runs_s = [run_s]
        for _ in range(2):
            t0 = time.perf_counter()
            again = cli.run_testcases(reads, haps, pairs, device="cuda")
            runs_s.append(time.perf_counter() - t0)
            if not np.array_equal(again, results):
                fail("a second run of the main path gave other results")
        run_s_median = float(np.median(runs_s))
        e2e = {"batches": len(batches), "testcases": len(pairs), "gcells": cells / 1e9,
               "parse_s": parse_s, "prep_s": stats["prep_s"], "f32_s": stats["f32_s"],
               "f64_s": stats["f64_s"], "run_s_all": runs_s, "run_s_median": run_s_median,
               "total_s": parse_s + run_s_median,
               "gcups_end_to_end": cells / (parse_s + run_s_median) / 1e9,
               "fallback_frac": stats["fallback"] / len(pairs), "launches": launches}
        log("end to end " + json.dumps(e2e))
        for name, n in launches.items():
            kern[name]["launches"] = n
            if n <= 0:
                fail(f"{name} was not launched on the main path")
        if not np.all(np.isfinite(results)) or results.shape != (len(pairs),):
            fail("main path gave non-finite likelihoods or a wrong shape")

        # where the device time goes: the same run again under torch.profiler
        prof = device_profile(torch, lambda: cli.run_testcases(reads, haps, pairs, device="cuda"))
        log("profile " + json.dumps(prof))

        # the CLI's printed lines for the first batches equal the pooled results
        n_cli = min(8, len(batches))
        small = Path(tmp) / "testfile_small.txt"
        with open(tf) as src, open(small, "w") as dst:
            for _ in range(n_cli):
                nr, nh = map(int, src.readline().split())
                dst.write(f"{nr} {nh}\n")
                for _ in range(nr + nh):
                    dst.write(src.readline())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-f", str(small)])
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("i: ")]
        want, pos = [], 0
        for bt in batches[:n_cli]:
            n = len(bt.pairs)
            want += [f"i: {i}; result_final: {v:f}" for i, v in enumerate(results[pos : pos + n])]
            pos += n
        if rc != 0 or lines != want:
            fail(f"CLI lines differ from the pooled results (rc {rc}, "
                 f"{len(lines)} vs {len(want)} lines)")
        log(f"CLI: {len(lines)} lines of {n_cli} batches equal the pooled results")

    # every raw output of the counted run against the plain version on the
    # same device tensors, bucket by bucket
    passes = (("phmm_forward_f32", torch.float32, "batch", "raw_f32"),
              ("phmm_forward_f64", torch.float64, "f64_batch", "raw_f64"))
    seen = {name: {"buckets": 0, "cases": 0, "plain_s": 0.0} for name in kern}
    for kb in kept:
        for name, dtype, bkey, rkey in passes:
            if kb[bkey] is None:
                continue
            plain_ms, want = time_ms(torch, lambda: P.phmm_forward_plain(kb[bkey], dtype), 1)
            kb[rkey + "_plain_ms"] = plain_ms
            got = torch.from_numpy(kb[rkey]).to(want.device)
            check(name, max_abs_diff(torch, got, want), f"main-path bucket {kb['bucket']}")
            seen[name]["buckets"] += 1
            seen[name]["cases"] += len(kb[rkey])
            seen[name]["plain_s"] += plain_ms * 1e-3
    log("main path vs plain, every output " + json.dumps(seen))

    # the kernels' times on the main path's largest bucket of each pass
    for name, dtype, bkey, rkey in passes:
        kb = max((kb for kb in kept if kb[bkey] is not None), key=lambda kb: len(kb[rkey]))
        tb = kb[bkey]
        ms, got = time_ms(torch, lambda: P.forward_raw(tb, dtype), 3)
        check(name, max_abs_diff(torch, got, torch.from_numpy(kb[rkey]).to(got.device)),
              f"a rerun on bucket {kb['bucket']}")
        tb_np = {k: v.cpu().numpy() for k, v in tb.items()}
        itemsize, peak = (4, F32_OPS_PER_S) if dtype == torch.float32 else (8, F64_OPS_PER_S)
        bms, by = bound(tb_np, itemsize, peak, n_tables)
        row = {"shape": f"{len(kb[rkey])} cases, bucket {kb['bucket'][0]}x{kb['bucket'][1]}",
               "ms": ms, "plain_ms": kb[rkey + "_plain_ms"],
               "gcups": cells_of(tb_np) / (ms * 1e-3) / 1e9, "bound_ms": bms, "bound_by": by}
        log(f"{name} on the main path's largest bucket " + json.dumps(row))
        kern[name].update(ms=ms, plain_ms=row["plain_ms"], bound_ms=bms, bound_by=by)

    # 16 seeded testcases against the port's oracle, exactly
    sel = np.random.default_rng(args.seed).choice(len(pairs), min(16, len(pairs)), replace=False)
    t0 = time.perf_counter()
    bad = []
    for i in sel:
        r, h = pairs[i]
        rd = reads[r]
        want_v = oracle.compute_likelihood(rd["bases"], haps[h], rd["q"], rd["i"],
                                           rd["d"], rd["c"])
        if want_v != results[i]:
            bad.append((int(i), want_v, float(results[i])))
    log(f"oracle sample: {len(sel) - len(bad)}/{len(sel)} exact "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad:
        fail(f"results differ from the oracle: {bad}")

    # 5. the kernels line, the card, the last line
    kernels = []
    for name, k in kern.items():
        kernels.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                        "launches": k["launches"], "max_abs_err": k["max_abs_err"],
                        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
