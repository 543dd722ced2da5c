"""Multi-process serving and training over ``torch.distributed`` (gloo) —
the port of ``tpu_cnn.parallel.multihost``.

The JAX package joins one process per host into one global runtime
(``jax.distributed``) and runs one SPMD program over every chip of every
host. The port keeps one process per host, each running its own mesh of
local devices single-controller (``parallel.mesh``); the processes agree
through ``torch.distributed`` with the gloo backend on the host: the
padding consensus (an all-reduce max), the topology check (an all-gather
of the local device counts) and, where every host needs every row, the
gathering of results to the host (:func:`allgather_to_host`). Results go
to the host anyway, and NCCL refuses two ranks on one GPU, so gloo
carries these small collectives. Each host feeds its own frames and gets
exactly their results back (:func:`local_rows`).

Training rides pure data parallelism: every process walks the same batch
stream and takes its slice of each global batch (:func:`global_batches`),
and the train step all-reduces its gradient over the processes as one
flattened buffer staged through the host (:func:`allreduce_mean_`);
ZeRO-1 gathers each process's updated parameter blocks the same way
(:func:`allgather_blocks_`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpu_cnn_torch.engine.cuda import DetectResult
from tpu_cnn_torch.parallel.mesh import (MeshEngine, Sharded, local_devices,
                                         make_mesh, shard_batch, to_host)

__all__ = [
    "MultiHostEngine",
    "allgather_blocks_",
    "allreduce_mean_",
    "global_batches",
    "init_multihost",
    "shutdown_multihost",
    "is_primary",
    "global_image_batch",
    "local_rows",
    "allgather_to_host",
]

# the CUDA devices init_multihost gave this process (None: all it sees);
# process-wide, like the process group it sits beside
_local_device_ids: list[int] | None = None


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   local_device_ids=None) -> None:
    """Join this process to the job's gloo process group.

    ``coordinator`` is ``host:port`` of process 0; ``local_device_ids``
    the CUDA devices this process owns (default: every one it sees). A
    single-process job (``num_processes == 1``) is a no-op, so CLI paths
    can call this unconditionally."""
    global _local_device_ids
    if num_processes <= 1:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _local_device_ids = (None if local_device_ids is None
                         else [int(i) for i in local_device_ids])


def shutdown_multihost() -> None:
    """Leave the process group, every rank together (a barrier first): a
    process that exits with the group up can abort in gloo's threads. A
    no-op where no group was joined."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side singletons (stdout
    reporting, snapshots, bundle export)."""
    return process_index() == 0


def owned_devices() -> list[torch.device]:
    """This process's CUDA devices: those given to :func:`init_multihost`,
    else every one it sees."""
    if _local_device_ids is None:
        return local_devices()
    return [torch.device("cuda", i) for i in _local_device_ids]


def _all_gather_ints(values: list[int]) -> np.ndarray:
    """(world, len(values)) int64: every rank's ``values``."""
    t = torch.tensor(values, dtype=torch.int64)
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def consensus_max(n: int) -> int:
    """The largest ``n`` over every rank (an all-reduce max)."""
    if process_count() == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def global_image_batch(mesh, images: np.ndarray, multiple: int = 1,
                       all_axes: bool = True) -> tuple[Sharded, int]:
    """This rank's frames, padded by consensus to the same count as every
    other rank's (a multiple of ``mesh.size * multiple``, at least one),
    and staged on its local mesh (every axis flattened by default, the
    megakernel's pure-batch layout). Returns (the sharded batch, the
    count of real frames). Every rank must call it together."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    b = images.shape[0]
    m = mesh.size * multiple
    pb = max(consensus_max(-(-b // m) * m), m)
    if pb != b:
        images = np.concatenate(
            [images, np.zeros((pb - b, *images.shape[1:]), np.uint8)])
    return shard_batch(mesh, images, all_axes), b


def local_rows(out: Sharded) -> np.ndarray:
    """This process's rows of a sharded result (its own frames' results;
    no cross-host traffic)."""
    return to_host(out)


def allgather_to_host(x) -> np.ndarray:
    """Every rank's rows (a numpy array or a :class:`Sharded`), in rank
    order, on every rank: the row counts, then the rows padded to the
    largest count, over gloo. Every rank must call it together."""
    x = np.ascontiguousarray(to_host(x) if isinstance(x, Sharded) else x)
    if process_count() == 1:
        return x
    sizes = _all_gather_ints([x.shape[0]])[:, 0]
    pad = np.zeros((int(sizes.max()), *x.shape[1:]), x.dtype)
    pad[:x.shape[0]] = x
    t = torch.from_numpy(pad)
    out = [torch.empty_like(t) for _ in sizes]
    dist.all_gather(out, t)
    return np.concatenate([o.numpy()[:n] for o, n in zip(out, sizes)])


def global_batches(mesh, host_batches):
    """This process's slices of the global batches.

    Every process iterates the same batch stream (same seed, same
    permutation) and takes the contiguous slice of each global batch that
    belongs to its positions: rows ``pid * k:(pid + 1) * k`` for ``k`` =
    batch / processes. A global batch that does not tile every position
    of every process is refused. Labels keep their dtype: integer labels
    stay integers and dense (soft) targets float32 (the JAX version casts
    both to int32, which zeroes 0.5/0.5 targets)."""
    n_proc, pid = process_count(), process_index()
    n_pos = mesh.size * n_proc
    for bi, bl in host_batches:
        if len(bi) % n_pos:
            # no silent row drop: the data axis spans every position of
            # every process, so the global batch must tile exactly
            raise ValueError(
                f"global batch {len(bi)} must divide by the mesh's device "
                f"count {n_pos} ({n_proc} processes)")
        k = len(bi) // n_proc
        sl = slice(pid * k, (pid + 1) * k)
        yield np.ascontiguousarray(bi[sl]), np.ascontiguousarray(bl[sl])


def allreduce_mean_(tensors) -> None:
    """Replace each tensor by its mean over the processes: one flattened
    f32 buffer, summed over gloo on the host, divided by the process
    count, copied back. Every process gets the same bits."""
    flat = torch.cat([t.detach().reshape(-1).to("cpu", torch.float32)
                      for t in tensors])
    dist.all_reduce(flat)
    flat /= process_count()
    o = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[o:o + n].view(t.shape).to(t.dtype))
        o += n


def allgather_blocks_(tensors, shards) -> None:
    """ZeRO-1's gather over processes: each process updated the rows of
    ``tensors[i]`` that ``shards[i]`` (a ``RowShards``) holds; every
    process's rows, flattened into one buffer, go to every process."""
    per = [len(s.parts) * s.parts[0].shape[0] for s in shards]
    mine = torch.cat([t[s.first * s.parts[0].shape[0]:][:n].reshape(-1).cpu()
                      for t, s, n in zip(tensors, shards, per)])
    out = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(out, mine)
    for rank, buf in enumerate(out):
        o = 0
        for t, n in zip(tensors, per):
            size = n * t[0].numel()
            t[rank * n:(rank + 1) * n].copy_(buf[o:o + size].view(n, *t.shape[1:]))
            o += size


class MultiHostEngine:
    """Per-host inference over every local device of every host.

    Construct it on every process (after ``init_multihost``) and call
    ``detect_batch``/``run_batch`` on every process together: the padding
    consensus is a collective. Each host feeds its own frames and gets
    results for exactly those frames; uneven per-host batches, a host with
    none included, are padded to the largest. Pure data parallelism: a
    ``MeshEngine`` over the local devices (``devices``, default
    :func:`owned_devices`) with the same backend choice."""

    def __init__(self, model, backend: str = "auto", box_mode: str = "ref",
                 devices=None):
        self._inner = MeshEngine(
            model, mesh=make_mesh(model_axis=1,
                                  devices=devices or owned_devices()),
            backend=backend, box_mode=box_mode)
        self.model = model
        self.mesh = self._inner.mesh
        self.backend = "multihost:" + self._inner.backend
        self._tile = self._inner._batch_mult // self.mesh.size
        if process_count() > 1:
            # the equal-rows padding consensus assumes every host owns an
            # equal share of the data axis: refuse an uneven topology up
            # front instead of mis-sharding at the first batch
            counts = _all_gather_ints([self.mesh.size])[:, 0]
            if int(counts.min()) != int(counts.max()):
                raise ValueError(
                    "MultiHostEngine needs a homogeneous topology (equal "
                    f"local device counts per host; saw {counts.tolist()})")

    def set_shifts(self, *shifts: int) -> None:
        self._inner.set_shifts(*shifts)

    def _stage(self, images: np.ndarray) -> tuple[Sharded, int]:
        s = self.model.config.img_size
        # the reshape pins the frame dims even for an empty local batch
        images = np.asarray(images, np.uint8).reshape(-1, s, s)
        return global_image_batch(self.mesh, images, self._tile,
                                  self._inner._all_axes)

    def warmup(self, batch: int = 1) -> None:
        s = self.model.config.img_size
        self.detect_batch(np.zeros((batch, s, s), np.uint8))

    def run_batch(self, images: np.ndarray) -> np.ndarray:
        sb, b = self._stage(images)
        return local_rows(self._inner.run_sharded(sb))[:b]

    def detect_batch(self, images: np.ndarray) -> DetectResult:
        sb, b = self._stage(images)
        return self._inner.detect_batch(("staged", sb, b))
