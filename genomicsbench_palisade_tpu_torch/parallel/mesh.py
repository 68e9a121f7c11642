"""The port's mesh: one process a device (a rank) in a torch.distributed group.

Counterpart of genomicsbench_palisade_tpu/parallel/mesh.py.  JAX's `Mesh`
is one controller over N devices whose `shard_map` bodies meet in `psum`,
`all_to_all` and `ppermute`; the torch idiom is one process a device.  So
`Mesh` holds the group, this rank, the world size and this rank's device,
and the collectives the sharded paths (parallel/dp.py) meet in are the
helpers below.

The backend is chosen, never found by catching an error (`choose_backend`):
NCCL when each rank has a card of its own; gloo on the CPU and when ranks
share one card (NCCL refuses two ranks on one device).  gloo takes CPU
tensors only for all_to_all and send/recv, so under gloo a collective on a
CUDA tensor goes through the host in one place, `_staged`; the kernels
still run on the card.  A failed init or collective raises: nothing goes
on at one rank or on the CPU in its place.

Without a group (`init_distributed` with no coordinator and no torchrun
environment) a mesh is one rank, and every collective is the identity.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
TIMEOUT_S = 600  # a collective that waits longer raises


@dataclass
class Mesh:
    """This rank's view of the group: the group (None for one rank without
    one), its backend, this rank, the world size and this rank's device."""

    group: object
    backend: str | None
    rank: int
    size: int
    device: torch.device

    @property
    def staged(self) -> bool:
        """Collectives on this rank's tensors go through the host (gloo on a
        card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of n items: ceil(n / size) a rank,
        the last ranks' shares short or empty (JAX's padded block split)."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return slice(lo, min(lo + per, n))


def choose_backend(device_type: str, local_ranks: int, local_cards: int,
                   shared: bool = False) -> str:
    """NCCL when every local rank has a card of its own, else gloo: on the
    CPU, and when the local ranks share a card (`shared`: every rank names
    one card, as `--device cuda:0` does)."""
    if device_type == "cuda" and local_ranks <= local_cards and not (shared and local_ranks > 1):
        return "nccl"
    return "gloo"


def backend_for(device=None, world: int = 1) -> str:
    """The backend of a group whose ranks each name `device`: None or
    "cuda" is each rank's own card (cuda:<local rank>), "cpu" the CPU, and
    a card with an index one card that the local ranks share.  The local
    ranks are LOCAL_WORLD_SIZE, else the world size."""
    dev = torch.device("cuda" if device is None else device)
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return choose_backend(dev.type, local_ranks, cards, shared=dev.index is not None)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None, timeout_s: float = TIMEOUT_S):
    """Join the process group (the counterpart of jax.distributed.initialize).

    coordinator: "host:port" of rank 0 (a TCP rendezvous); num_processes
    and process_id: the world size and this rank.  With no coordinator the
    torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR) is used when it is
    set, else this is a one-rank run and no group is made.  `backend`
    defaults to `backend_for(device, world size)`, device being what each
    rank will name (None: its own card).  Returns the backend, or None
    without a group; a second call is a no-op."""
    if dist.is_initialized():
        return dist.get_backend()
    env = coordinator is None
    if env and not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return None  # a one-rank run
    world = int(os.environ["WORLD_SIZE"]) if env else int(num_processes)
    rank = int(os.environ["RANK"]) if env else int(process_id)
    if backend is None:
        backend = backend_for(device, world)
    dist.init_process_group(backend=backend,
                            init_method="env://" if env else f"tcp://{coordinator}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def shutdown():
    """Leave the group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_devices: int | None = None, axis: str = DP_AXIS, device=None) -> Mesh:
    """This rank's mesh over the group's ranks (one axis: `axis` is taken
    for the JAX signature).  n_devices, when given, must be the world size.
    device: this rank's device; None or "cuda" is cuda:<local rank> in a
    group (the current card without one), which must exist (ranks that
    share a card name it, as `device="cuda:0"`); "cpu" for the CPU.
    Without a GPU and without the CPU named this raises."""
    grouped = dist.is_initialized()
    size = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs that many ranks, the group "
                         f"has {size}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        if device.index is None:
            local = _local_rank() if grouped else torch.cuda.current_device()
            if local >= torch.cuda.device_count():
                raise RuntimeError(f"local rank {local} has no card of its own "
                                   f"({torch.cuda.device_count()} visible): ranks that "
                                   "share a card pass its device, and the group runs on gloo")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = dist.get_backend() if grouped else None
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group runs on CUDA devices")
    return Mesh(dist.group.WORLD if grouped else None, backend, rank, size, device)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad, constant_values=fill), n


def shard_batch(batch: dict, mesh: Mesh, axis: str = DP_AXIS):
    """This rank's rows of every array of `batch` (numpy), dim 0 zero-padded
    to a multiple of the world size first, as JAX pads before it shards;
    keys ending in `_t` (the TPU kernel's transposed copies) are skipped.
    Returns (rows, n_orig)."""
    del axis
    out = {}
    n_orig = None
    for key, arr in batch.items():
        if key.endswith("_t"):
            continue
        padded, n = pad_to_multiple(np.asarray(arr), mesh.size, axis=0)
        n_orig = n if n_orig is None else n_orig
        per = padded.shape[0] // mesh.size
        out[key] = padded[mesh.rank * per : (mesh.rank + 1) * per]
    return out, n_orig


def host_local_slice(n_items: int) -> slice:
    """This process's slice of a globally ordered input list (each process
    reads only its share of the FASTQ or pairs)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = -(-n_items // size)
    lo = rank * per
    return slice(lo, min(lo + per, n_items))


def shard_work_imbalance(work_per_item, n_shards: int) -> float:
    """The reference's maxTicks/avgTicks load imbalance (fmi.cpp:362-370),
    statically sharded: item work is assigned round-robin to shards;
    returns max/avg shard work."""
    work = np.asarray(work_per_item, np.float64)
    shard_tot = np.zeros(n_shards)
    for i, w in enumerate(work):
        shard_tot[i % n_shards] += w
    avg = shard_tot.mean()
    return float(shard_tot.max() / avg) if avg > 0 else 1.0


# ---------------------------------------------------------------- collectives


def _staged(mesh: Mesh, tensors, op):
    """Run `op` on `tensors` as the backend takes them: under gloo, CUDA
    tensors go to the host first and their results come back; bool tensors
    travel as uint8.  op gets the list and returns the results."""
    if not mesh.staged and not any(t.dtype == torch.bool for t in tensors):
        return op(tensors)
    host = [(t.cpu() if mesh.staged else t) for t in tensors]
    host = [t.to(torch.uint8) if t.dtype == torch.bool else t for t in host]
    out = op(host)
    return [o.to(device=t.device, dtype=t.dtype) for o, t in zip(out, tensors)]


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of t (JAX's psum), on every rank."""
    if mesh.group is None:
        return t
    if t.dtype == torch.bool:
        raise ValueError("all_reduce_sum takes numbers, not bool")

    def op(ts):
        x = ts[0].contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
        return [x]

    return _staged(mesh, [t], op)[0]


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's t (the same shape on each), concatenated along dim 0 in
    rank order."""
    if mesh.group is None:
        return t

    def op(ts):
        x = ts[0].contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return [torch.cat(parts)]

    return _staged(mesh, [t], op)[0]


def all_gather_v(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's t, whose dim 0 may differ from rank to rank,
    concatenated along dim 0 in rank order."""
    if mesh.group is None:
        return t
    sizes = all_gather(mesh, torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device))
    sizes = sizes.tolist()
    top = max(sizes)
    pad = t.new_zeros((top - t.shape[0], *t.shape[1:]))
    whole = all_gather(mesh, torch.cat([t, pad]))
    return torch.cat([whole[r * top : r * top + s] for r, s in enumerate(sizes)])


def gather_rows(mesh: Mesh, a: np.ndarray) -> np.ndarray:
    """Every rank's numpy rows (dim 0 may differ), concatenated in rank
    order.  Host rows stay on the host under gloo; NCCL takes them on the
    rank's card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    return all_gather_v(mesh, t).cpu().numpy()


def all_to_all_v(mesh: Mesh, t: torch.Tensor, send_counts) -> torch.Tensor:
    """Rows t[sum(send_counts[:d]) : ... + send_counts[d]] go to rank d; the
    counts are exchanged first, then the rows in one all_to_all_single with
    split sizes.  Returns the rows received, in rank order."""
    send_counts = [int(c) for c in send_counts]
    if mesh.group is None:
        return t

    def op(ts):
        x = ts[0].contiguous()
        sc = torch.tensor(send_counts, dtype=torch.int64, device=x.device)
        rc = torch.empty_like(sc)
        dist.all_to_all_single(rc, sc, group=mesh.group)
        recv_counts = rc.tolist()
        out = x.new_empty((sum(recv_counts), *x.shape[1:]))
        dist.all_to_all_single(out, x, output_split_sizes=recv_counts,
                               input_split_sizes=send_counts, group=mesh.group)
        return [out]

    return _staged(mesh, [t], op)[0]


def send(mesh: Mesh, t: torch.Tensor, dst: int):
    """Send t to rank dst (JAX's ppermute, one hop)."""
    _staged(mesh, [t], lambda ts: (dist.send(ts[0].contiguous(), dst, group=mesh.group), ts)[1])


def recv(mesh: Mesh, like: torch.Tensor, src: int) -> torch.Tensor:
    """A tensor shaped as `like`, received from rank src."""

    def op(ts):
        x = torch.empty_like(ts[0])
        dist.recv(x, src, group=mesh.group)
        return [x]

    return _staged(mesh, [like], op)[0]


def barrier(mesh: Mesh):
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------- local launch


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n, port, backend, timeout_s, args):
    init_distributed(f"127.0.0.1:{port}", n, rank, backend=backend, timeout_s=timeout_s)
    try:
        fn(rank, *args)
    finally:
        shutdown()


def spawn(fn, n: int, args=(), backend: str = "gloo", timeout_s: float = TIMEOUT_S):
    """Run fn(rank, *args) in n new processes joined in one group on
    localhost (a torchrun on one host); returns when all have ended and
    raises if any failed.  fn must be importable by name (a module-level
    function): the processes are spawned, not forked."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(fn, n, free_port(), backend, timeout_s, tuple(args)),
             nprocs=n, join=True)
