"""Random occ-row gather probes: the XOR fold of table rows picked by indices.

Counterpart of tools/occ_gather_experiment.py's Pallas probes `_kernel`
(wrapper `dma_gather_xor`) and `_bw_kernel` (wrapper `dma_bw_xor`), whose
CUDA kernels are csrc/occ_gather.cu.  The table is int64 [rows, 8], one
64-byte row each, like the FM index's cp_occ (ops/fmi.py); indices are
int32.

  * `occ_gather_row(table, idx, rows_in_flight)`: int64 [8], the XOR of
    rows idx[i] (2 or 8 rows in flight a quad of lanes; the probe's nslots).
  * `occ_gather_tile(table, idx)`: int64 [64], the XOR of the 512-byte
    groups of 8 rows starting at row 8 * (idx[i] >> 3) (the tile row the
    Pallas probe moved whole); the row count must be a multiple of 8
    (`pad_to_tiles`).

Each dispatches on the table's device: a CPU tensor goes to the plain
version (`index_select` on the table, then an XOR fold), a CUDA tensor to
the kernel, whose wrapper (`occ_gather_row_cuda`, `occ_gather_tile_cuda`)
raises on anything else and counts its launches.  Every index is folded:
the Pallas grid dropped the last n % 512.

Each launch's depth (rows in flight a quad of lanes, or tiles a warp:
csrc/occ_gather.cu) comes from LAYOUTS, measured on the card by
tools/gather_lanes.py, which builds the source with other depths through
`defines`.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel import CudaKernel, check_tensor, require_cuda

SOURCE = "occ_gather"
ROW_WORDS = 8  # int64 words of a 64-byte row
TILE_ROWS = 8  # rows of a 512-byte tile
ROWS_IN_FLIGHT = (2, 8)
# the depth of each launch: row2 and row8 are occ_gather_row with 2 and 8
# rows in flight (rows a quad of lanes), tile is occ_gather_tile (tiles a
# warp).  Measured on the card by tools/gather_lanes.py (PERF.md); built as
# -DOCC_<ROW2|ROW8|TILE>_DEPTH.
LAYOUTS = {"row2": 2, "row8": 8, "tile": 8}


def layout_defines(layouts=None) -> tuple:
    """The build's ("OCC_<LAUNCH>_DEPTH", depth) pairs: LAYOUTS with the
    given launches' depths put over it."""
    return tuple((f"OCC_{k.upper()}_DEPTH", d) for k, d in {**LAYOUTS, **(layouts or {})}.items())


def xor_fold(rows: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of an integer tensor [n, w] -> [w] (zeros if n == 0),
    by halving: torch has no XOR reduction."""
    if rows.shape[0] == 0:
        return torch.zeros(rows.shape[1:], dtype=rows.dtype, device=rows.device)
    while rows.shape[0] > 1:
        h = rows.shape[0] // 2
        folded = rows[:h] ^ rows[h : 2 * h]
        if rows.shape[0] % 2:
            folded[0] ^= rows[-1]
        rows = folded
    return rows[0]


def occ_gather_row_plain(table, idx) -> torch.Tensor:
    return xor_fold(table.index_select(0, idx))


def occ_gather_tile_plain(table, idx) -> torch.Tensor:
    return xor_fold(table.view(-1, TILE_ROWS * ROW_WORDS).index_select(0, idx >> 3))


def pad_to_tiles(table) -> torch.Tensor:
    """The table with zero rows appended up to a multiple of 8 rows."""
    extra = -table.shape[0] % TILE_ROWS
    if not extra:
        return table
    return torch.cat([table, table.new_zeros((extra, table.shape[1]))])


def _check(name, table, idx, tile_rows=1):
    dev = table.device
    require_cuda(name, dev)
    check_tensor(name, "table", table, dev, torch.int64, (table.shape[0], ROW_WORDS))
    check_tensor(name, "idx", idx, dev, torch.int32, (idx.numel(),))
    if table.shape[0] % tile_rows:
        raise ValueError(f"{name}: the table's {table.shape[0]} rows are not a multiple of "
                         f"{tile_rows} (pad_to_tiles)")
    return dev


class OccGatherRowKernel(CudaKernel):
    def __init__(self, layouts=None):
        super().__init__("occ_gather_row", SOURCE,
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                         "occ_gather_error_string", layout_defines(layouts))

    def __call__(self, table, idx, rows_in_flight=8) -> torch.Tensor:
        dev = _check(self.name, table, idx)
        out = torch.zeros(ROW_WORDS, dtype=torch.int64, device=dev)
        if idx.numel():
            self.launch(dev, table.data_ptr(), idx.data_ptr(), idx.numel(), table.shape[0],
                        rows_in_flight, out.data_ptr())
        return out


class OccGatherTileKernel(CudaKernel):
    def __init__(self, layouts=None):
        super().__init__("occ_gather_tile", SOURCE,
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_void_p, ctypes.c_void_p],
                         "occ_gather_error_string", layout_defines(layouts))

    def __call__(self, table, idx) -> torch.Tensor:
        dev = _check(self.name, table, idx, TILE_ROWS)
        out = torch.zeros(TILE_ROWS * ROW_WORDS, dtype=torch.int64, device=dev)
        if idx.numel():
            self.launch(dev, table.data_ptr(), idx.data_ptr(), idx.numel(), table.shape[0],
                        out.data_ptr())
        return out


occ_gather_row_cuda = OccGatherRowKernel()
occ_gather_tile_cuda = OccGatherTileKernel()
KERNELS = (occ_gather_row_cuda, occ_gather_tile_cuda)


def occ_gather_row(table, idx, rows_in_flight=8) -> torch.Tensor:
    if rows_in_flight not in ROWS_IN_FLIGHT:
        raise ValueError(f"rows_in_flight must be one of {ROWS_IN_FLIGHT}")
    if table.device.type == "cpu":
        return occ_gather_row_plain(table, idx)
    return occ_gather_row_cuda(table, idx, rows_in_flight)


def occ_gather_tile(table, idx) -> torch.Tensor:
    if table.device.type == "cpu":
        return occ_gather_tile_plain(table, idx)
    return occ_gather_tile_cuda(table, idx)
