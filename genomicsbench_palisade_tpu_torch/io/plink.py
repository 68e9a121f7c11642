"""plink .bed/.bim/.fam and plink2 .pgen/.pvar/.psam input (grm's host I/O).

The port's own copy of genomicsbench_palisade_tpu/io/plink.py: the same
decoders, giving the same int8 genotype matrices ([M, N], ALT dosage
0/1/2, 3 = missing).  The writer packs its 2-bit codes with numpy shifts
instead of a loop a genotype; its bytes are the JAX writer's.

.bed (variant-major, mode 0x01): per variant ceil(N/4) bytes, 2 bits a
sample, low bits first: 00 -> 2, 01 -> missing, 10 -> 1, 11 -> 0.

.pgen: the hardcall decoder transcribed from the PGEN spec and reader
(benchmarks/grm/2.0/include/pgenlib_misc.h:688-840, pgenlib_read.cc:
1790-1905): modes 0x02 (fixed-width) and 0x10/0x11 with hardcall vrtypes
0-7 (plain / 1-bit + difflist / LD / difflist); multiallelic, phase and
dosage tracks are refused.
"""

from __future__ import annotations

import numpy as np

_DECODE = np.zeros((256, 4), dtype=np.int8)
for byte in range(256):
    for k in range(4):
        two = (byte >> (2 * k)) & 3
        _DECODE[byte, k] = {0: 2, 1: 3, 2: 1, 3: 0}[two]  # 3 = missing
_ENCODE = np.array([3, 2, 0, 1], np.uint8)  # dosage 0/1/2/missing -> its 2-bit code


def _decode_rows(table: np.ndarray, raw: np.ndarray, n: int) -> np.ndarray:
    """[M, bytes] packed rows -> [M, n] int8 through a [256, 4] table: each
    byte's four genotypes gathered as one uint32 (5x the 2-d gather)."""
    words = table.view(np.uint32).ravel()[raw]
    geno = words.view(np.int8).reshape(raw.shape[0], 4 * raw.shape[1])
    return geno if geno.shape[1] == n else geno[:, :n].copy()


def read_bed(prefix: str):
    """Returns (geno [M, N] int8 with 3=missing, sample_ids, variant_ids)."""
    fam = []
    with open(prefix + ".fam") as f:
        for line in f:
            parts = line.split()
            if parts:
                fam.append(parts[0] + "\t" + parts[1])
    bim = []
    with open(prefix + ".bim") as f:
        for line in f:
            parts = line.split()
            if parts:
                bim.append(parts[1])
    n = len(fam)
    m = len(bim)
    bytes_per_variant = (n + 3) // 4
    with open(prefix + ".bed", "rb") as f:
        magic = f.read(3)
        if magic[:2] != b"\x6c\x1b":
            raise ValueError("not a .bed file")
        if magic[2] != 1:
            raise ValueError("only variant-major .bed supported")
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    return _decode_rows(_DECODE, raw.reshape(m, bytes_per_variant), n), fam, bim


def pack_bed(geno: np.ndarray) -> np.ndarray:
    """[M, ceil(N/4)] uint8: each genotype's 2-bit code at bits 2*(j%4) of
    byte j//4; the padding samples' bits stay 0, as the JAX writer's."""
    geno = np.asarray(geno)
    if geno.size and (geno.min() < 0 or geno.max() > 3):
        raise ValueError("genotypes must be 0, 1, 2 or 3 (missing)")
    m, n = geno.shape
    codes = np.zeros((m, (n + 3) // 4 * 4), np.uint8)
    codes[:, :n] = _ENCODE[geno]
    return (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
            | (codes[:, 3::4] << 6))


def write_bed(prefix: str, geno: np.ndarray, sample_ids=None, variant_ids=None):
    """Inverse of read_bed: the .bed, .fam and .bim of the JAX writer."""
    m, n = geno.shape
    with open(prefix + ".bed", "wb") as f:
        f.write(b"\x6c\x1b\x01")
        pack_bed(geno).tofile(f)
    with open(prefix + ".fam", "w") as f:
        f.write("".join((sample_ids[j] if sample_ids else f"F{j}\tI{j}").replace("\t", " ")
                        + " 0 0 0 -9\n" for j in range(n)))
    with open(prefix + ".bim", "w") as f:
        f.write("".join(f"1 {variant_ids[i] if variant_ids else f'snp{i}'} 0 {i + 1} A C\n"
                        for i in range(m)))


_PGEN_DECODE = np.zeros((256, 4), dtype=np.int8)
for _byte in range(256):
    for _k in range(4):
        # 00=hom ref(0) 01=het(1) 10=hom alt(2) 11=missing(3)
        _PGEN_DECODE[_byte, _k] = (_byte >> (2 * _k)) & 3


class _PgenCursor:
    def __init__(self, buf, pos=0):
        self.buf = buf
        self.pos = pos

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return int(v)

    def bytes(self, n):
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def uint(self, nbytes):
        return int.from_bytes(self.bytes(nbytes), "little")

    def vint31(self):
        # GetVint31 (pgenlib_misc.h:281-296): LEB128, 7 bits per byte
        v = self.u8()
        if v <= 127:
            return v
        v &= 127
        shift = 7
        while True:
            b = self.u8()
            v |= (b & 127) << shift
            if b <= 127:
                return v
            shift += 7


def _unpack_2bit(raw, n):
    return _PGEN_DECODE[np.frombuffer(raw, np.uint8)].reshape(-1)[:n].copy()


def _parse_difflist(cur: _PgenCursor, n: int, with_geno: bool = True):
    """Difflist (pgenlib_misc.h:774-800): returns (sample_ids, raregeno)."""
    dl_len = cur.vint31()
    if dl_len == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int8)
    group_ct = (dl_len + 63) // 64
    sid_bc = (max(n, 1).bit_length() - 1) // 8 + 1  # BytesToRepresentNzU32
    starts = [cur.uint(sid_bc) for _ in range(group_ct)]
    cur.bytes(group_ct - 1)  # per-group byte lengths (random-access only)
    if with_geno:
        raregeno = _unpack_2bit(cur.bytes((dl_len + 3) // 4), dl_len)
    else:
        raregeno = np.zeros(dl_len, np.int8)
    ids = np.zeros(dl_len, np.int64)
    k = 0
    for g in range(group_ct):
        size = min(64, dl_len - g * 64)
        cur_id = starts[g]
        ids[k] = cur_id
        k += 1
        for _ in range(size - 1):
            cur_id += cur.vint31()
            ids[k] = cur_id
            k += 1
    return ids, raregeno


def _read_pgen_ids(pvar_path, psam_path, m: int, n: int):
    sample_ids, variant_ids = [], []
    if psam_path:
        with open(psam_path) as f:
            header_cols = None
            for line in f:
                if line.startswith("#"):
                    header_cols = line[1:].split()
                    continue
                parts = line.split()
                if not parts:
                    continue
                if header_cols and header_cols[0] == "IID":
                    sample_ids.append(parts[0] + "\t" + parts[0])
                else:
                    sample_ids.append(parts[0] + "\t" + parts[1])
    if pvar_path:
        with open(pvar_path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                variant_ids.append(line.split()[2])
    if sample_ids and len(sample_ids) != n:
        raise ValueError(f".psam has {len(sample_ids)} samples, the .pgen {n}")
    if variant_ids and len(variant_ids) != m:
        raise ValueError(f".pvar has {len(variant_ids)} variants, the .pgen {m}")
    return sample_ids, variant_ids


def read_pgen(pgen_path: str, pvar_path: str | None = None,
              psam_path: str | None = None):
    """Returns (geno [M, N] int8 alt-dosage with 3=missing, sample_ids,
    variant_ids)."""
    with open(pgen_path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"\x6c\x1b":
        raise ValueError("not a .pgen file")
    mode = buf[2]
    cur = _PgenCursor(buf, 3)
    m = cur.uint(4)
    n = cur.uint(4)
    geno = np.zeros((m, n), np.int8)
    if mode == 0x02:
        cur.u8()  # control byte (zeroed for fixed-width modes)
        bpv = (n + 3) // 4
        geno[:] = _decode_rows(_PGEN_DECODE, np.frombuffer(cur.bytes(bpv * m), np.uint8)
                               .reshape(m, bpv), n)
    elif mode in (0x10, 0x11):
        ctrl = cur.u8()
        vrec_len_bc = (ctrl & 3) + 1
        wide_vrtypes = bool(ctrl & 4)
        if ctrl & 8:
            raise ValueError("fused vrtype-length encoding not supported")
        allele_ct_bc = (ctrl >> 4) & 3
        nonref_storage = (ctrl >> 6) & 3
        vblock = 65536
        n_vblocks = (m + vblock - 1) // vblock
        fpos = [cur.uint(8) for _ in range(n_vblocks)]
        vrtypes = np.zeros(m, np.uint8)
        vrec_lens = np.zeros(m, np.int64)
        for vb in range(n_vblocks):
            cnt = min(vblock, m - vb * vblock)
            base = vb * vblock
            if wide_vrtypes:
                vrtypes[base : base + cnt] = np.frombuffer(cur.bytes(cnt), np.uint8)
            else:
                packed = np.frombuffer(cur.bytes((cnt + 1) // 2), np.uint8)
                pairs = np.stack([packed & 15, packed >> 4], 1).reshape(-1)
                vrtypes[base : base + cnt] = pairs[:cnt]
            for i in range(cnt):
                vrec_lens[base + i] = cur.uint(vrec_len_bc)
            if allele_ct_bc:
                cur.bytes(allele_ct_bc * cnt)
            if nonref_storage == 3:
                cur.bytes((cnt + 7) // 8)
        ld_base = None
        for i in range(m):
            vb = i // vblock
            if i % vblock == 0:
                rec_pos = fpos[vb]
            rc = _PgenCursor(buf, rec_pos)
            rec_pos += int(vrec_lens[i])
            vt = int(vrtypes[i])
            if vt & 0xF8:
                raise ValueError(f"unsupported vrtype {vt:#x} (multiallelic/phase/dosage)")
            low = vt & 7
            if low == 0:
                row = _unpack_2bit(rc.bytes((n + 3) // 4), n)
            elif low == 5:  # all hom ref, no missing
                row = np.zeros(n, np.int8)
            elif low in (4, 6, 7):  # difflist from constant base
                row = np.full(n, low & 3, np.int8)
                ids, vals = _parse_difflist(rc, n)
                row[ids] = vals
            elif low in (2, 3):  # LD: diffs from last non-LD variant
                row = ld_base.copy()
                ids, vals = _parse_difflist(rc, n)
                row[ids] = vals
                if low == 3:  # inverted: swap hom ref <-> hom alt
                    row = np.where(row == 0, np.int8(2), np.where(row == 2, np.int8(0), row))
            else:  # low == 1: 1-bit main track + difflist
                fmt = rc.u8()
                diff = fmt & 3
                unset = (fmt >> 2) & 3
                bits = np.unpackbits(np.frombuffer(rc.bytes((n + 7) // 8), np.uint8),
                                     bitorder="little")[:n]
                row = (unset + bits.astype(np.int8) * diff) & 3
                ids, vals = _parse_difflist(rc, n)
                row[ids] = vals
            if low not in (2, 3):
                ld_base = row
            geno[i] = row
    else:
        raise ValueError(f"unsupported .pgen mode {mode:#x}")
    sample_ids, variant_ids = _read_pgen_ids(pvar_path, psam_path, m, n)
    return geno, sample_ids, variant_ids
