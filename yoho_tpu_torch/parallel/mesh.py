"""The device mesh and its collectives: the port's one comm module.

The JAX package's ``parallel/mesh.py`` is one controller over a named
``jax.sharding.Mesh``; PyTorch's idiom is one process per rank (SPMD),
launched by ``torchrun``. Every rank runs the same program on the same
host inputs; the layers above this module speak mesh axis names only.

Axis convention (as in the JAX package):

* ``data``: batch rows. A rank computes its rows (:func:`shard_batch`) and
  the results are gathered over ``data`` (:func:`gather_batch`) before the
  host reads them, so every rank takes the same host branches (a branch on
  a value one rank alone holds would leave the others waiting in a
  collective).
* ``model``: tensor parallel (attention heads, MLP hidden units, experts,
  vocabulary rows); the row-parallel layers sum their partial outputs over
  it (:func:`all_reduce`).

Meshes of other axis names (``seq`` for ring attention, ``pipe`` for the
pipelined encoder) come from :func:`init_mesh`.

Backend by device: NCCL for CUDA, gloo for the CPU. A rank's device is
``cuda:LOCAL_RANK`` unless the caller passes ``device="cpu"``; without
CUDA that is an error, never a CPU run. Without a launcher (none of
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``
set) :func:`init_distributed` starts a group of one process itself, so a
mesh of size 1 runs in one process with no launcher. A group of one is no
special case: its collectives run (NCCL's on the card) and are counted.

NCCL's flight recorder is off unless ``TORCH_FR_BUFFER_SIZE`` (or the
older ``TORCH_NCCL_TRACE_BUFFER_SIZE``) is set (:func:`init_distributed`):
it captures the Python stack of every collective, which costs more than
the collective on the decode loop.

Every collective of this module adds one to :data:`COUNTS` under
``"<op>/<axis>"`` (``all_reduce``, ``all_gather``, ``broadcast``,
``send``, ``recv``, ``barrier``), as the kernel wrappers count their
launches (``ops/_build.py``).

The serving schedule (:func:`broadcast_obj`, :func:`agree`): a server
over a mesh takes requests on rank 0 alone, while every device call is a
collective, so every rank must run the same admissions and chunks in the
same order. Rank 0 (the leader) broadcasts, once a tick, the host inputs
only it sees (new requests with their audio, cancellations, the close),
and the ranks agree at the end of a tick on whether it succeeded. Both go
over a gloo group of their own on the host (``"broadcast_obj/world"``,
``"all_reduce/world"``), never the NCCL one: a follower waits there while
the server idles. Every rank makes that group at the same point, in the
same order as its other groups: :func:`open_schedule`, which a batcher
over a mesh calls when it is built (its :class:`ScheduleChannel`; on
every rank, never on a worker thread that rank 0 alone runs).

Training (the differentiable collectives, :func:`reduce_gradients`): every
rank runs backward on its own loss. Where the loss is replicated over an
axis (``model``, ``seq``, ``pipe``) each rank holds the whole loss, so a
collective's backward must count it once, not once per rank: the
``model`` pair of Megatron (:func:`copy_to` before a column-parallel
layer, identity forward and an all-reduced gradient; :func:`sum_over` at
the row-parallel output, all-reduce forward and the gradient as it is),
:func:`gather_over` whose backward keeps this rank's slice of a gradient
every rank holds whole (``grad="slice"``) or sums the ranks' gradients
before slicing when each rank's loss is its own share (``grad="sum"``),
:func:`broadcast_from` whose backward is the source's own gradient, and
:func:`ring_shift` whose backward sends the gradient the reverse way
(JAX's transpose of ``ppermute``). Over ``data`` each rank's loss is its
share of the global batch's loss, so the trained leaves' gradients sum
over ``data`` (:func:`reduce_gradients`, once per applied update).
"""

from __future__ import annotations

import datetime
import math
import os
import socket
import time
from collections import Counter
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

COUNTS: Counter = Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _count(op: str, axis: str, n: int = 1) -> None:
    if n:
        COUNTS[f"{op}/{axis}"] += n


def launched() -> bool:
    """True under a launcher (``torchrun`` sets the rank environment)."""
    return any(k in os.environ for k in _LAUNCH_ENV)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` by default (raises without
    CUDA), else what the caller names."""
    from yoho_tpu_torch.core.device import resolve_device

    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def world_size() -> int:
    """Processes in the group (started or about to be): 1 without a
    launcher."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1)) if launched() else 1


def init_distributed(device=None) -> torch.device:
    """Join (or start) the process group and return this rank's device.

    Under a launcher the group comes from its environment (``env://``);
    without one a group of one process is started on a free localhost
    port. NCCL for a CUDA device, gloo for the CPU. Safe to call again."""
    dev = local_device(device)
    if not dist.is_initialized():
        # NCCL's flight recorder (on by default) captures the Python stack
        # of every collective: about 0.4 ms each on the decode loop's deep
        # stack, which doubled a whisper-small batch's wall on an H100
        # (PERF.md). Set either variable to keep the recorder.
        if not {"TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE"} & set(os.environ):
            os.environ["TORCH_FR_BUFFER_SIZE"] = "0"
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        if launched():
            dist.init_process_group(backend, **kw)
        else:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    world_size=1, rank=0, **kw)
    return dev


class Mesh:
    """A named mesh of ranks over ``torch.distributed.device_mesh``:
    ``shape`` maps each axis name to its size (the JAX mesh's
    ``mesh.shape``), ``device`` is this rank's device, and each axis has
    the process group of the ranks that share this rank's other
    coordinates."""

    def __init__(self, shape: Mapping[str, int], device: torch.device, device_mesh):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.device = device
        self.device_mesh = device_mesh
        self._coord = dict(zip(self.axis_names, device_mesh.get_coordinate()))
        self._groups = {a: device_mesh.get_group(a) for a in self.axis_names}

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an axis the mesh
        lacks)."""
        return self._coord.get(axis, 0)

    def group(self, axis: str):
        return self._groups[axis]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` on ``axis`` with this rank's other
        coordinates."""
        return dist.get_global_rank(self._groups[axis], index)

    def __repr__(self) -> str:
        dims = "x".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, device={self.device})"


_MESHES: Dict[tuple, Mesh] = {}
# The serving schedule's gloo group (module doc, :func:`open_schedule`).
# A leader that idles sends an empty tick every ``SCHEDULE_IDLE_S``
# (``infer/continuous.py``, ``infer/batching.py``), so a follower waits at
# most that long between ticks; the timeout only ends the followers of a
# leader that hangs (one that dies closes its sockets: they raise at once).
SCHEDULE_IDLE_S = 1.0
SCHEDULE_TIMEOUT = datetime.timedelta(minutes=30)
_SCHEDULE = None


def init_mesh(shape: Mapping[str, int], device=None) -> Mesh:
    """A mesh of the given axes (``{"seq": 4}``, ``{"data": 2, "pipe":
    2}``) over every rank of the group, row-major: the last axis varies
    fastest. Its size must be the world size. Meshes are kept per shape
    and device (building one is a collective)."""
    shape = {str(a): int(n) for a, n in shape.items()}
    if any(n < 1 for n in shape.values()):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    size = math.prod(shape.values())
    n = world_size()
    if size != n:
        raise ValueError(f"mesh {'x'.join(map(str, shape.values()))} != {n} devices")
    dev = init_distributed(device)
    key = (tuple(shape.items()), dev)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        dm = init_device_mesh(dev.type, tuple(shape.values()),
                              mesh_dim_names=tuple(shape))
        _MESHES[key] = Mesh(shape, dev, dm)
    return _MESHES[key]


def shutdown() -> None:
    """Destroy the process group (and forget its meshes): the end of a run
    that started one."""
    global _SCHEDULE
    _MESHES.clear()
    _SCHEDULE = None
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over every rank. ``data=-1`` absorbs what
    ``model`` does not use. Raises ``ValueError`` as the JAX package's
    ``make_mesh`` does when the axes do not fit the world size."""
    n = world_size()
    if model < 1 or n % model != 0:
        raise ValueError(f"model axis size {model} does not divide device count {n}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return init_mesh({AXIS_DATA: data, AXIS_MODEL: model}, device)


def parse_mesh(spec: str, device=None) -> Mesh:
    """A command line's mesh spec -> (data, model) mesh: ``"2x4"`` is
    2-way data x 4-way tensor parallel; the data factor may be ``-1``."""
    parts = spec.lower().split("x")
    try:
        if len(parts) != 2:
            raise ValueError
        data, model = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"mesh spec {spec!r} is not DATAxMODEL (e.g. '2x4', '-1x8')") from None
    return make_mesh(data, model, device)


def as_mesh(mesh, device=None) -> Mesh:
    """A :class:`Mesh`, or a ``"DxM"`` spec parsed into one on ``device``;
    anything else raises ``TypeError`` naming what a mesh is."""
    if isinstance(mesh, str):
        return parse_mesh(mesh, device)
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a yoho_tpu_torch.parallel.mesh.Mesh (from make_mesh, "
            f"parse_mesh or init_mesh) or a 'DATAxMODEL' spec, got {type(mesh).__name__}")
    return mesh


# ---------------------------------------------------------------------------
# Collectives (each counted)
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = AXIS_MODEL,
               op: str = "sum") -> torch.Tensor:
    """``t`` summed (or maxed) over ``axis``, in place; returns it."""
    _count("all_reduce", axis)
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    dist.all_reduce(t, op=ops[op], group=mesh.group(axis))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along ``dim`` in axis
    order."""
    _count("all_gather", axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=mesh.group(axis))
    return torch.cat(parts, dim)


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, src_index: int) -> torch.Tensor:
    """``t`` of the rank at ``src_index`` on ``axis``, in place."""
    _count("broadcast", axis)
    dist.broadcast(t, mesh.peer(axis, src_index), group=mesh.group(axis))
    return t


def exchange(mesh: Mesh, axis: str, sends: Sequence[tuple] = (),
             recvs: Sequence[tuple] = ()) -> None:
    """Point-to-point over ``axis`` in one batch: ``sends`` and ``recvs``
    are ``(tensor, index on the axis)`` pairs; returns when all are done."""
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, t.contiguous(), mesh.peer(axis, i), group)
           for t, i in sends]
    ops += [dist.P2POp(dist.irecv, t, mesh.peer(axis, i), group) for t, i in recvs]
    _count("send", axis, len(sends))
    _count("recv", axis, len(recvs))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a batch (an array or tensor, or a dict, list or
    tuple of them): the leading axis split over ``data`` in axis order.
    Raises ``ValueError`` when the rows do not divide, as the JAX
    package's placement does."""
    d, i = mesh.shape.get(AXIS_DATA, 1), mesh.index(AXIS_DATA)

    def rows(x):
        n = x.shape[0]
        if n % d:
            raise ValueError(f"batch of {n} rows does not divide over the "
                             f"{AXIS_DATA} axis of {d}: pass a batch divisible by {d}")
        k = n // d
        return x[i * k:(i + 1) * k]

    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return rows(batch)


def gather_batch(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The whole batch from every ``data`` rank's rows (the inverse of
    :func:`shard_batch`)."""
    if AXIS_DATA not in mesh.shape:
        return t
    return all_gather(t, mesh, AXIS_DATA, 0)


def process_shard() -> tuple:
    """This process's ``(index, count)`` in the group: ``(0, 1)`` without
    one. The writers' gate (:func:`is_coordinator`); a trainer's loaders
    shard by :func:`data_shard`."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_shard(mesh) -> tuple:
    """This rank's ``(index, count)`` on the ``data`` axis: ``(0, 1)``
    without a mesh or a ``data`` axis. The loaders' shard and the local
    batch: ranks that differ only in ``model`` (or ``seq``, ``pipe``) load
    the same rows, as JAX's per-host shard feeds one host's model axis."""
    if mesh is None:
        return 0, 1
    return mesh.index(AXIS_DATA), mesh.shape.get(AXIS_DATA, 1)


def is_coordinator() -> bool:
    """True on the process that writes artifacts and leads a server's
    schedule: rank 0, or any single-process run."""
    return process_shard()[0] == 0


def local_batch_size(global_batch: int, mesh=None) -> int:
    """This rank's share of a global batch over the ``data`` axis of
    ``mesh`` (all of it without one); raises when it does not divide."""
    count = data_shard(mesh)[1]
    if global_batch % count:
        raise ValueError(
            f"batch_size {global_batch} must divide by the data axis {count} "
            f"(each rank loads batch_size/{count} local rows)")
    return global_batch // count


def data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A device scalar (or tensor) summed over the ``data`` axis, out of
    place and without a gradient: ``x`` itself without a mesh or a
    ``data`` axis. The global batch's mask count, a loss's global value."""
    if mesh is None or AXIS_DATA not in mesh.shape:
        return x
    return all_reduce(x.detach().reshape(-1).clone(), mesh, AXIS_DATA).view_as(x)


def open_schedule() -> None:
    """Make the serving schedule's gloo group (once a process group): a
    collective, so every rank calls it at the same point of its program
    (a batcher over a mesh, when it is built)."""
    global _SCHEDULE
    if not dist.is_initialized():
        raise RuntimeError("the serving schedule needs the process group of a mesh "
                           "(make_mesh, parse_mesh or init_mesh) on every rank")
    if _SCHEDULE is None:
        _SCHEDULE = dist.new_group(backend="gloo", timeout=SCHEDULE_TIMEOUT)


def _schedule_group():
    if _SCHEDULE is None:
        raise RuntimeError("the serving schedule is not open: open_schedule() on every "
                           "rank first")
    return _SCHEDULE


def broadcast_obj(obj=None):
    """Rank 0's ``obj`` (any picklable host object) on every rank, over the
    schedule group; the other ranks pass nothing. One counted broadcast."""
    group = _schedule_group()
    _count("broadcast_obj", "world")
    box = [obj if is_coordinator() else None]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def agree(values: Sequence[int]) -> Tuple[list, list]:
    """The ranks' largest and smallest of each integer in ``values``, over
    the schedule group: one counted all-reduce. A tick's end, where the
    ranks agree on whether its device work succeeded everywhere."""
    group = _schedule_group()
    _count("all_reduce", "world")
    t = torch.tensor([int(v) for v in values] + [-int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    n = len(values)
    return t[:n].tolist(), (-t[n:]).tolist()


class ScheduleChannel:
    """A batcher's end of the serving schedule (the module doc): opens the
    schedule's group (every rank, where the batcher is built) and counts
    the ticks it broadcast or received and the host seconds spent in them
    and in the agreements."""

    def __init__(self):
        open_schedule()
        self.ticks = 0
        self.host_s = 0.0

    def broadcast(self, tick=None):
        """Rank 0's ``tick`` on every rank (:func:`broadcast_obj`)."""
        t0 = time.perf_counter()
        tick = broadcast_obj(tick)
        self.host_s += time.perf_counter() - t0
        self.ticks += 1
        return tick

    def agree(self, values: Sequence[int]) -> Tuple[list, list]:
        """The ranks' largest and smallest of each value (:func:`agree`)."""
        t0 = time.perf_counter()
        out = agree(values)
        self.host_s += time.perf_counter() - t0
        return out


def barrier(name: str) -> None:
    """A sync point of every rank (a no-op without a group)."""
    if dist.is_initialized():
        COUNTS[f"barrier/{name}"] += 1
        dist.barrier()


def fetch_to_host(mesh: Mesh, tree, specs=None, to_host: bool = True):
    """Host (numpy) copies of a tree of tensors. ``specs`` (a tree of
    partition specs, ``parallel/sharding.py``) names the axes each leaf is
    split over on this mesh: those leaves are gathered first. Every rank
    must call it, in the same order; a rank that passes ``to_host=False``
    (one that writes nothing) takes part in the gathers, copies nothing
    and gets None."""
    out = _fetch(mesh, tree, specs, to_host)
    return out if to_host else None


def _fetch(mesh: Mesh, tree, specs, to_host: bool):
    if isinstance(tree, dict):
        return {k: _fetch(mesh, v, None if specs is None else specs.get(k), to_host)
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree
    for dim, axis in enumerate(specs or ()):
        if axis is not None and axis in mesh.shape:
            t = all_gather(t, mesh, axis, dim)
    if not to_host:
        return None
    # A copy: a CPU tensor's numpy() would alias the live (trained) leaf.
    return t.detach().to("cpu", torch.float32 if t.is_floating_point() else t.dtype,
                         copy=True).numpy()


# ---------------------------------------------------------------------------
# Differentiable collectives (training; see the module doc)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), None, None


class _SumOver(torch.autograd.Function):
    """All-reduce forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOver(torch.autograd.Function):
    """All-gather forward; the backward takes this rank's slice of the
    gradient, summed over the axis first when ``total``."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, total):
        ctx.mesh, ctx.axis, ctx.dim, ctx.total = mesh, axis, dim, total
        ctx.size = x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.total:
            g = all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis)
        i = ctx.mesh.index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(), None, None, None, None


class _BroadcastFrom(torch.autograd.Function):
    """Broadcast forward from ``src`` on the axis; the backward gives the
    source its own gradient and the other ranks zeros (the loss after it
    is replicated, so the source counts it once)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, src):
        ctx.src = mesh.index(axis) == src
        return broadcast(x.contiguous().clone(), mesh, axis, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.src else torch.zeros_like(g)), None, None, None


class _RingShift(torch.autograd.Function):
    """Every tensor sent to the next rank of the axis and the previous
    rank's received (one batch); the backward sends the gradients the
    reverse way."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift(mesh, axis, xs, +1)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + _shift(ctx.mesh, ctx.axis, gs, -1)


def _shift(mesh, axis: str, xs, step: int) -> tuple:
    n, i = mesh.shape[axis], mesh.index(axis)
    outs = tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in xs)
    exchange(mesh, axis, sends=[(x, (i + step) % n) for x in xs],
             recvs=[(o, (i - step) % n) for o in outs])
    return outs


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor, mesh, axis: str = AXIS_MODEL) -> torch.Tensor:
    """The input of a column-parallel layer: ``x`` itself; under autograd
    its gradient is all-reduced over ``axis`` (each rank's layer slice
    gives a part of it). No collective without a gradient."""
    return _CopyTo.apply(x, mesh, axis) if _differentiable(x) else x


def sum_over(x: torch.Tensor, mesh, axis: str = AXIS_MODEL) -> torch.Tensor:
    """``x`` summed over ``axis``: in place without a gradient (serving),
    else out of place with the gradient passed through."""
    if _differentiable(x):
        return _SumOver.apply(x, mesh, axis)
    return all_reduce(x.contiguous(), mesh, axis)


def gather_over(x: torch.Tensor, mesh, axis: str, dim: int = 0,
                grad: str = "slice") -> torch.Tensor:
    """:func:`all_gather` under autograd: the backward keeps this rank's
    slice of the gradient (``"slice"``: the loss after the gather is
    replicated, every rank holds the whole gradient) or of its sum over
    the axis (``"sum"``: each rank's loss is its own share)."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be 'slice' or 'sum', got {grad!r}")
    if _differentiable(x):
        return _GatherOver.apply(x, mesh, axis, dim, grad == "sum")
    return all_gather(x, mesh, axis, dim)


def broadcast_from(x: torch.Tensor, mesh, axis: str, src_index: int) -> torch.Tensor:
    """:func:`broadcast` under autograd (the source takes the gradient
    once)."""
    if _differentiable(x):
        return _BroadcastFrom.apply(x, mesh, axis, src_index)
    return broadcast(x.contiguous(), mesh, axis, src_index)


def ring_shift(mesh, axis: str, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` passed one rank on along the ring of ``axis`` (rank i
    sends to i + 1, receives from i - 1), in one batch; differentiable
    (the gradients travel back, i + 1 to i)."""
    if any(_differentiable(x) for x in xs):
        return _RingShift.apply(mesh, axis, *xs)
    return _shift(mesh, axis, xs, +1)


BUCKET_ELEMENTS = 1 << 25  # 128 MiB of float32 a collective at most


def reduce_gradients(grads: Mapping[str, torch.Tensor], mesh, axes,
                     bucket_elements: int = BUCKET_ELEMENTS) -> None:
    """Sum gradients over mesh axes, in place: each leaf's tensors
    flattened into buckets of at most ``bucket_elements`` (by type), one
    counted all-reduce a bucket and axis. ``axes`` is a tuple of axis
    names for every leaf, or a callable ``path -> axes``; axes the mesh
    lacks are skipped."""
    if mesh is None:
        return
    axes_of = axes if callable(axes) else (lambda _k: axes)
    groups: Dict[tuple, list] = {}
    for k, g in grads.items():
        ax = tuple(a for a in axes_of(k) if a in mesh.shape)
        if ax:
            groups.setdefault((ax, g.dtype, g.device), []).append(g)
    for (ax, _dt, _dev), leaves in groups.items():
        for bucket in _buckets(leaves, bucket_elements):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            for a in ax:
                all_reduce(flat, mesh, a)
            off = 0
            for g in bucket:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()


def _buckets(leaves: Sequence[torch.Tensor], cap: int) -> Iterable[list]:
    bucket, size = [], 0
    for g in leaves:
        if bucket and size + g.numel() > cap:
            yield bucket
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    if bucket:
        yield bucket
