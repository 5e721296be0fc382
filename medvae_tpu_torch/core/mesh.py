"""The device mesh over torch.distributed (counterpart of medvae_tpu/core/mesh.py).

One torch process is one JAX device: a rank on its own card, or a gloo rank
on the CPU. One node (`world_size // LOCAL_WORLD_SIZE` of them) is one JAX
process, and JAX's `dcn` axis runs over nodes. Ranks are started by
`torchrun` (or by a test's spawn with a `file://` store).

  * `MeshSpec` and `resolve` are the JAX package's, with the same errors.
  * `init_distributed(device)` reads torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT) or the
    arguments a test passes. Without either it returns world 1 and starts
    no group, so a single process runs exactly as before.
  * The backend is chosen once and said once: NCCL when each rank of a node
    has its own card; gloo on the CPU, or when the ranks of a node share a
    card (LOCAL_WORLD_SIZE > torch.cuda.device_count(): NCCL refuses two
    ranks on one device, "Duplicate GPU detected").
  * `create_mesh(spec, dist)` lays the ranks out as JAX lays out devices:
    (data, model) row-major, or (dcn, data, model) with one dcn row a node,
    through `torch.distributed.device_mesh.init_device_mesh`. Its groups:
    `data`, `model`, and `batch` (the ranks the batch is sharded over:
    (dcn, data) jointly, the data group when there is one node).
  * `Mesh.local_rows(n)` is the `P(batch_axes)` layout of an n-row global
    batch: rows [r·n/N, (r+1)·n/N) belong to batch-rank r of N; the model
    ranks of one batch-rank hold the same rows.
  * `replicate(mesh, tensors)` broadcasts from rank 0 in place.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, Optional

import torch

DCN_AXIS = "dcn"
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Static description of the mesh layout (medvae_tpu/core/mesh.py:39-57).

    ``dcn``: 0 = auto (the node count); 1 = no cross-node axis (a 2-D mesh);
    >1 = an explicit cross-node axis."""

    data: int = -1  # -1: all remaining devices
    model: int = 1
    dcn: int = 0

    def resolve(self, n_devices: int, n_processes: int = 1) -> tuple[int, int, int]:
        dcn = self.dcn if self.dcn > 0 else max(1, n_processes)
        model = max(1, self.model)
        per_slice = n_devices // dcn
        data = self.data if self.data > 0 else per_slice // model
        if dcn * data * model != n_devices:
            raise ValueError(
                f"mesh ({dcn} x {data} x {model}) does not tile {n_devices} devices"
            )
        return dcn, data, model


@dataclasses.dataclass
class Dist:
    """This process's place in the job: its rank, the world, its node, the
    device it computes on and the backend of the default group (None when
    no group was started)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None

    @property
    def nodes(self) -> int:
        return max(1, self.world // max(1, self.local_world))

    @property
    def started(self) -> bool:
        return self.backend is not None


_DIST: Optional[Dist] = None


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def choose_backend(device: torch.device, local_world: int) -> tuple[str, str]:
    """(backend, why): NCCL when each of the `local_world` ranks of a host
    has its own card, gloo on the CPU or when ranks share a card."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if local_world > cards:
        return "gloo", (f"{local_world} ranks share {cards} card(s); NCCL refuses two ranks on one "
                        "device, so collectives go through gloo")
    return "nccl", f"one card a rank ({local_world} on this node)"


def init_distributed(
    device: Any = "cuda",
    *,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_world_size: Optional[int] = None,
    host_world_size: Optional[int] = None,
) -> Dist:
    """Start (once a process) the default group from torchrun's environment
    or the arguments given, and pick this rank's device: `cpu`, or the card
    (`cuda`, `gpu` and `tpu` all mean it; raises without one). A card of its
    own a rank when the node has enough, else the node's ranks share card
    local_rank % count. `host_world_size` (a dry run's spawn, which lays
    several nodes on one host) is the ranks on this host when more than a
    node's: the card and the backend then follow the rank among them.
    Without torchrun's environment and without arguments: world 1, no
    group, the device as asked."""
    global _DIST
    if _DIST is not None and _DIST.started:
        return _DIST
    name = str(device).lower()
    want_cuda = name.split(":")[0] in ("cuda", "gpu", "tpu")
    if want_cuda and not torch.cuda.is_available():
        raise RuntimeError(f"device={name} asks for the card and there is no CUDA device; "
                           "pass device=cpu to run on the CPU")
    world = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    rank = rank if rank is not None else _env_int("RANK", 0)
    local_world = local_world_size if local_world_size is not None else _env_int("LOCAL_WORLD_SIZE", world)
    local_rank = rank % local_world if local_world else 0
    if "LOCAL_RANK" in os.environ and init_method is None:
        local_rank = _env_int("LOCAL_RANK", local_rank)
    host_world = host_world_size or local_world
    slot = local_rank if host_world == local_world else rank % host_world
    torchrun = "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ
    if not want_cuda:
        dev = torch.device("cpu")
    elif init_method is None and not torchrun:
        dev = torch.device(name if ":" in name else "cuda")
    else:
        dev = torch.device("cuda", slot % torch.cuda.device_count())
    if init_method is None and not torchrun:
        _DIST = Dist(device=dev)
        return _DIST
    import torch.distributed as dist

    backend, why = choose_backend(dev, host_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs: Dict[str, Any] = dict(backend=backend, rank=rank, world_size=world)
    if init_method is not None:
        kwargs["init_method"] = init_method
    if backend == "nccl":
        kwargs["device_id"] = dev
    if not dist.is_initialized():
        dist.init_process_group(**kwargs)
    _DIST = Dist(rank=rank, world=world, local_rank=local_rank, local_world=local_world,
                 device=dev, backend=backend)
    if rank == 0:
        print(f"distributed: world {world} ({_DIST.nodes} node(s) of {local_world}), "
              f"backend {backend}: {why}", flush=True)
    return _DIST


def current() -> Dist:
    """The process's Dist (world 1 on the CPU before `init_distributed`)."""
    return _DIST if _DIST is not None else Dist()


def shutdown() -> None:
    """Destroy the default group this process started, if any."""
    global _DIST
    if _DIST is not None and _DIST.started:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _DIST = None


@dataclasses.dataclass
class Mesh:
    """The (dcn, data, model) layout of the job and this rank's coordinates
    and groups (a group is None where its axis has one rank and no
    collective is needed, and everywhere at world 1 without a group)."""

    dcn: int
    data: int
    model: int
    dist: Dist
    device_mesh: Any = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def axis_names(self) -> tuple:
        return (DCN_AXIS, DATA_AXIS, MODEL_AXIS) if self.dcn > 1 else (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        out = {DATA_AXIS: self.data, MODEL_AXIS: self.model}
        if self.dcn > 1:
            out[DCN_AXIS] = self.dcn
        return out

    @property
    def rank(self) -> int:
        return self.dist.rank

    @property
    def coords(self) -> tuple[int, int, int]:
        """(dcn, data, model) of this rank: rank = ((dcn·data) + data)·model + model."""
        r = self.dist.rank
        return r // (self.data * self.model), (r // self.model) % self.data, r % self.model

    @property
    def batch_extent(self) -> int:
        """How many ways the batch is split: dcn × data."""
        return self.dcn * self.data

    @property
    def batch_rank(self) -> int:
        d, i, _ = self.coords
        return d * self.data + i

    @property
    def model_rank(self) -> int:
        return self.coords[2]

    def group(self, name: str):
        """The group of axis `name` (`data`, `model`, `batch`, `world`)
        this rank belongs to, or None when it holds this rank alone and no
        group was started."""
        return self.groups.get(name)

    def local_rows(self, n: int) -> slice:
        """This rank's rows of an n-row global batch (n must divide by the
        batch extent)."""
        extent = self.batch_extent
        if n % extent:
            raise ValueError(f"global batch {n} not divisible by the batch extent {extent} "
                             f"(dcn {self.dcn} x data {self.data})")
        local = n // extent
        return slice(self.batch_rank * local, (self.batch_rank + 1) * local)


def batch_axes(mesh: Mesh):
    """Mesh axes the batch dimension shards over: (dcn, data) on a 3-D mesh."""
    return (DCN_AXIS, DATA_AXIS) if mesh.dcn > 1 else DATA_AXIS


def create_mesh(spec: Optional[MeshSpec] = None, dist_info: Optional[Dist] = None) -> Mesh:
    """The job's mesh: `spec` resolved over the world and its node count.
    At world 1 without a group it is the trivial (1, 1) mesh and has no
    groups; with a group (a one-rank NCCL group, say) the groups exist and
    every collective runs, as an identity."""
    d = dist_info or current()
    spec = spec or MeshSpec()
    dcn, data, model = spec.resolve(d.world, d.nodes)
    if dcn > 1 and d.world // dcn != d.local_world:
        raise ValueError(f"mesh dcn={dcn}: one dcn row a node needs {d.world // dcn} ranks a node, "
                         f"and this job runs {d.local_world}")
    mesh = Mesh(dcn=dcn, data=data, model=model, dist=d)
    if not d.started:
        return mesh
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (dcn, data, model) if dcn > 1 else (data, model)
    mesh.device_mesh = init_device_mesh(d.device.type, shape, mesh_dim_names=mesh.axis_names)
    mesh.groups[DATA_AXIS] = mesh.device_mesh.get_group(DATA_AXIS)
    mesh.groups[MODEL_AXIS] = mesh.device_mesh.get_group(MODEL_AXIS)
    mesh.groups["world"] = dist.group.WORLD
    if dcn > 1:
        # the batch group: every rank of this rank's model coordinate, over
        # all nodes; every rank creates every such group, in order
        per_model = [[r for r in range(d.world) if r % model == m] for m in range(model)]
        mesh.groups["batch"], _ = dist.new_subgroups_by_enumeration(per_model, backend=d.backend)
    else:
        mesh.groups["batch"] = mesh.groups[DATA_AXIS]
    return mesh


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast `tensors` from rank 0 to every rank, in place (the same
    seeded init, or a restored checkpoint, on every rank)."""
    group = mesh.group("world")
    if group is None:
        return
    import torch.distributed as dist

    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=0, group=group)


def barrier(mesh_or_dist=None) -> None:
    """Wait for every rank (nothing at world 1 without a group)."""
    d = mesh_or_dist.dist if isinstance(mesh_or_dist, Mesh) else (mesh_or_dist or current())
    if d.started:
        import torch.distributed as dist

        if d.backend == "nccl":
            dist.barrier(device_ids=[d.device.index])
        else:
            dist.barrier()


def broadcast_object(obj: Any, dist_info: Optional[Dist] = None) -> Any:
    """Rank 0's `obj` on every rank (a sweep's stamp, a probe's answer)."""
    d = dist_info or current()
    if not d.started:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, device=d.device if d.backend == "nccl" else None)
    return box[0]
