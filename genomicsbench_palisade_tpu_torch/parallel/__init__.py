"""The sharded runtime: a process a device in a torch.distributed group
(`mesh`), and the sharded paths with their collectives (`dp`).  The
counterpart of genomicsbench_palisade_tpu/parallel."""

from .mesh import make_mesh, pad_to_multiple, shard_batch  # noqa: F401
