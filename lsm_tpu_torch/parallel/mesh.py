"""Process mesh and sharding helpers (port of lsm_tpu/parallel/mesh.py).

lsm_tpu runs one controller over many devices; the port runs one process
per device (a rank of `torch.distributed`) and lays the ranks out on a
`DeviceMesh` with the dimensions ("data", "model") (DATA_AXIS, MODEL_AXIS).
Data parallelism over utterances is the primary axis; model parallelism
over reservoir neurons (parallel/sharded.py) is there for scaled
reservoirs. Every rank calls the same function with the same global host
arrays (lsm_tpu's multi-host contract), computes its own rows and gathers
the results.

Collectives run on the mesh's process groups: NCCL where each rank has a
GPU of its own, gloo on the CPU and where ranks share a GPU (NCCL refuses
two ranks on one card). gloo takes CUDA tensors only for all_reduce and
broadcast, so those are the only two collectives used: a gather is an
all_reduce of a zeroed buffer in which each rank fills its own slot,
summed as bytes (exact: every byte has one nonzero contributor).

`collectives` and `collective_bytes` count the collectives that
`gather_rows`, `deliver_rows` and `all_reduce_sum` issue and the bytes of
the buffers they hand to them (a gather's whole zeroed buffer, every
rank's slot); a call that needs no collective counts nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import socket
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

collectives = 0          # collectives issued by gather_rows, deliver_rows, all_reduce_sum
collective_bytes = 0     # bytes of the buffers handed to them


def _count(buf: torch.Tensor) -> None:
    global collectives, collective_bytes
    collectives += 1
    collective_bytes += buf.numel() * buf.element_size()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) layout of the ranks and this rank's compute device.
    `shape` reads as lsm_tpu's mesh.shape: {"data": n_data, "model":
    n_model}."""

    device_mesh: "dist.device_mesh.DeviceMesh"
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.device_mesh.mesh_dim_names, self.device_mesh.mesh.shape))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return int(self.device_mesh.get_coordinate()[self.device_mesh.mesh_dim_names.index(axis)])


def _compute_device(device: Optional[torch.device]) -> torch.device:
    """This rank's device: `device` as given for the CPU, else the GPU of
    its local rank (several ranks may share one GPU under gloo)."""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def _mesh_of(grid: np.ndarray, device: Optional[torch.device]) -> Mesh:
    from torch.distributed.device_mesh import DeviceMesh

    dev = _compute_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(kind, torch.as_tensor(grid), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(dm, dev)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """A (data, model) mesh over the ranks in order, all of them on the data
    axis by default. A collective: every rank calls it, in the same order
    as the other collectives."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, "
                         f"have {world}")
    return _mesh_of(np.arange(world).reshape(n_data, n_model), device)


@functools.lru_cache(maxsize=None)
def _auto_mesh(world: int, device: torch.device) -> Mesh:
    return make_mesh(n_data=world, n_model=1, device=device)


def auto_mesh(min_devices: int = 2, device: Optional[torch.device] = None) -> Optional[Mesh]:
    """The default mesh: every rank on the data axis, made once a process;
    None below `min_devices` ranks or outside a process group (the
    single-device path needs no mesh)."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if world < min_devices:
        return None
    return _auto_mesh(world, torch.device(device if device is not None else "cpu"))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad `axis` up to a multiple (so shards are equal); returns (padded, n_real)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a batch of n along the data axis (n must divide
    evenly: pad first)."""
    n_data = mesh.shape[DATA_AXIS]
    if n % n_data:
        raise ValueError(f"batch of {n} does not divide over {n_data} data shards")
    per = n // n_data
    i = mesh.index(DATA_AXIS)
    return slice(i * per, (i + 1) * per)


def shard_host_array(x, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the FULL host batch `x` (identical on every
    rank), on the rank's device."""
    x = np.asarray(x)
    return torch.as_tensor(np.ascontiguousarray(x[local_rows(x.shape[0], mesh)])).to(mesh.device)


def shard_batch(x, mesh: Mesh) -> torch.Tensor:
    """lsm_tpu's name for `shard_host_array` along the data axis."""
    return shard_host_array(x, mesh)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS, dim: int = 0) -> torch.Tensor:
    """All-gather the ranks' equal slices along tensor dimension `dim`
    over mesh axis `axis`, in coordinate order ((n, ...) -> (size * n, ...)
    for dim 0), on every rank of the group, as one all_reduce of bytes
    (see the module docstring). Exact for any dtype."""
    size = mesh.shape[axis]
    if size == 1:
        return x
    if dim:
        return gather_rows(x.movedim(dim, 0), mesh, axis).movedim(0, dim).contiguous()
    x = x.contiguous()
    if x.numel() == 0:
        return x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    raw = x.view(torch.uint8).reshape(x.shape[0], -1) if x.dim() else x.view(1).view(torch.uint8)
    buf = torch.zeros((size,) + tuple(raw.shape), dtype=torch.uint8, device=x.device)
    buf[mesh.index(axis)] = raw
    _count(buf)
    dist.all_reduce(buf, group=mesh.group(axis))
    return buf.view(x.dtype).reshape((size * x.shape[0],) + tuple(x.shape[1:]))


def local_stream_rows(n_streams: int, mesh: Optional[Mesh]) -> int:
    """Stream rows this rank feeds a serving chunk: all of them without a
    mesh, else its share of the data axis (the engines refuse a stream
    count that does not divide). Rank r feeds the rows of its data
    coordinate, `local_rows(n_streams, mesh)`. On a mesh with a model axis
    above 1, every rank of one data coordinate serves the same rows (the
    serving engines replicate the reservoir over the model axis, as
    lsm_tpu's shard_map does). lsm_tpu divides by its process count
    instead; the two agree on the (n, 1) meshes that auto_mesh and
    multihost_mesh give."""
    if mesh is None:
        return n_streams
    return n_streams // mesh.shape[DATA_AXIS]


def place_stream_chunk(chunk: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host serving chunk, already normalized and holding this rank's
    stream rows (`local_stream_rows`), on the rank's device by a plain
    copy: a CPU engine's placement. A CUDA engine stages its host chunks
    through its page-locked slots instead, by a copy ordered on the
    current stream (models/streaming.py `place_chunk`, `IngestSlots`)."""
    return torch.as_tensor(np.asarray(chunk)).to(device)


def deliver_rows(parts, mesh: Mesh, axis: str = DATA_AXIS) -> list:
    """Sum equal-shaped tensors over `axis` as bytes, in one all_reduce:
    each rank passes buffers that are zero except where it alone writes,
    and every rank gets the union (exact for any dtype, as gather_rows).
    The serving engines deliver extracted stream rows so."""
    parts = [p.contiguous() for p in parts]
    if mesh.shape[axis] == 1 or not parts:
        return parts
    raws = [p.reshape(-1).view(torch.uint8) for p in parts]
    flat = torch.cat(raws)
    if flat.numel():
        _count(flat)
        dist.all_reduce(flat, group=mesh.group(axis))
    out, off = [], 0
    for p, r in zip(parts, raws):
        # A copy: a byte slice at an odd offset cannot be viewed as wider words.
        out.append(flat[off:off + r.numel()].clone().view(p.dtype).reshape(p.shape))
        off += r.numel()
    return out


def gather_columns(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """All-gather (B, n) column slices along `axis` into (B, size * n), in
    coordinate order (the tensor-parallel spike gather)."""
    return gather_rows(x, mesh, axis, dim=1)


def host_local(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The full value of a data-sharded result on every rank: this rank's
    rows all-gathered over the data axis (lsm_tpu's all-gather of a
    sharded array to replicated). Without a mesh, x itself."""
    if mesh is None:
        return x
    return gather_rows(x, mesh, DATA_AXIS)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over the ranks of the data axis, in place, and returned."""
    if mesh.shape[DATA_AXIS] > 1:
        _count(x)
        dist.all_reduce(x, group=mesh.group(DATA_AXIS))
    return x


def replicate_to_mesh(tree, mesh: Mesh):
    """Every tensor of `tree` (a tensor, an nn.Module's parameters and
    buffers, or a tuple / list of them) broadcast in place from rank
    0, so that all ranks hold the same bits (reservoir weights come from a
    shared seed and calibration constant, so they already agree; this makes
    it so). Returns `tree`."""
    for t in _tensors(tree):
        if dist.get_world_size() > 1:
            dist.broadcast(t.data, src=0)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


# ---------------------------------------------------------------------------
# The multi-process runtime
# ---------------------------------------------------------------------------

def default_backend(local_world: int) -> str:
    """NCCL where each local rank has a GPU of its own, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None) -> None:
    """Join the process group (one call per process, before any mesh).
    With a coordinator "host:port", the process grid is given; without one,
    torch's launcher environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, as torchrun sets them) describes it. The backend defaults to NCCL
    where every rank of this host has its own GPU, else gloo. `timeout`
    bounds the rendezvous and every collective of the group (a rank that
    died leaves the others raising, or NCCL's watchdog ending them, once it
    passes); None keeps torch's default."""
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
        local_world = world
    else:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend or default_backend(local_world), init_method=init_method,
                            world_size=world, rank=rank, **kw)


def maybe_init_distributed_from_env() -> bool:
    """The entry points' env contract, as lsm_tpu's: LSM_TPU_COORDINATOR=
    host:port with LSM_TPU_NUM_PROCESSES and LSM_TPU_PROCESS_ID on every
    process, or LSM_TPU_DISTRIBUTED=1 under torch's own launcher. Returns
    True when this process joined a group."""
    coord = os.environ.get("LSM_TPU_COORDINATOR")
    if coord:
        init_distributed(coord, int(os.environ["LSM_TPU_NUM_PROCESSES"]),
                         int(os.environ["LSM_TPU_PROCESS_ID"]))
        return True
    if os.environ.get("LSM_TPU_DISTRIBUTED"):
        init_distributed()
        return True
    return False


def is_primary() -> bool:
    """True on rank 0, and outside a process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Wait for every rank: an all_reduce of one int on the mesh's device
    (gloo has no barrier on CUDA tensors)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        if mesh is not None:
            dev = mesh.device
        elif dist.get_backend() == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device("cpu")
        dist.all_reduce(torch.zeros(1, dtype=torch.int32, device=dev))


def multihost_mesh(n_model: int = 1, device: Optional[torch.device] = None) -> Mesh:
    """A (data, model) mesh whose model groups stay inside one host: the
    per-step tensor-parallel gathers stay on the host's links, and the data
    axis (independent utterances and small readout reductions) is what
    crosses hosts. n_model must divide every host's rank count; ranks are
    ordered host-major."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    order = sorted(range(len(hosts)), key=lambda r: (hosts.index(hosts[r]), r))
    per_host = {h: hosts.count(h) for h in hosts}
    if n_model > 1 and any(c % n_model for c in per_host.values()):
        raise ValueError(f"n_model={n_model} must divide the ranks of every host "
                         f"({per_host}) so the tensor-parallel gathers stay inside one")
    grid = np.asarray(order).reshape(len(order) // n_model, n_model)
    return _mesh_of(grid, device)
