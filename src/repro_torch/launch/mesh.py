"""One silo per process: the process group DPASGD gossips over.

Counterpart of ``repro.launch.mesh.make_silo_mesh``: where the reference
lays the silos on a 1-D device mesh and gossips with ``ppermute`` inside
``shard_map``, the port runs one process per silo under
``torch.distributed``.  Rank r hosts silo label r of the universe; the
*active* silos (all of them, or the survivors of churn under
``--dynamic``) are ordered by label, and position i of a gossip plan is
silo ``active[i]``, hosted by rank ``active[i]``.  An idle rank (its silo
left) takes part in no transfer until its silo rejoins.

A :class:`SiloMesh` holds the process group, the active silos, each
rank's device, a ``gloo`` control group (broadcasts of Python objects and
the losses, under NCCL too) and the transport.  Two backends:

* ``nccl`` sends the device buffers as they are, one card per rank;
* ``gloo`` sends CPU tensors as they are.  A rank whose buffers live on a
  card (several ranks may share one: NCCL refuses that) stages every
  transfer through pinned host buffers of ``chunk_bytes`` and counts the
  bytes it staged and the seconds the copies took.

The backend is the caller's explicit choice; ``nccl`` with two ranks on
one device raises, and nothing moves a rank to the CPU or to ``gloo``
unasked.  :func:`spawn` starts ranks for tests and scripts with
``torch.multiprocessing.spawn`` (the ``spawn`` start method) and a
``file://`` store in a temporary directory, so no TCP port is needed;
``torchrun`` sets ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` and the
``env://`` rendezvous instead.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")
# Bytes per pinned staging buffer (2^26 float32 values).
CHUNK_BYTES = 1 << 28


def default_backend(device: torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device: DeviceLike, rank: int) -> torch.device:
    """``cuda`` without an index is ``cuda:LOCAL_RANK`` (the rank when
    ``LOCAL_RANK`` is unset); an explicit index is kept, so ranks may share
    a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return dev


def _check_backend(backend: str, dev: torch.device, rank: int) -> None:
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl sends CUDA buffers; rank {rank} is on {dev}: "
                         "pass backend='gloo' to run on the CPU")


def _device_key(dev: torch.device) -> Tuple[str, str]:
    if dev.type != "cuda":
        return (socket.gethostname(), "cpu")
    props = torch.cuda.get_device_properties(dev)
    return (socket.gethostname(), str(getattr(props, "uuid", dev.index)))


class SiloMesh:
    """The ranks, their devices, the active silos and the transport.

    Build it with :func:`silo_mesh` (from an initialised default process
    group) or :func:`init_silo_mesh`.  ``active`` starts as every rank;
    :meth:`set_active` follows churn (every rank calls it with the same
    set, since it makes the active ranks' subgroups).  ``recv_bytes``,
    ``staged_bytes`` and ``staging_s`` count the payload received, the
    bytes copied through pinned host memory and the seconds those copies
    took since the mesh was made."""

    def __init__(self, rank: int, world_size: int, device: torch.device, backend: str,
                 control):
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.backend = backend
        self.control = control
        self.chunk_bytes = CHUNK_BYTES
        self.active: Tuple[int, ...] = tuple(range(world_size))
        self.recv_bytes = 0
        self.staged_bytes = 0
        self.staging_s = 0.0
        self._groups: Dict[Tuple[str, Tuple[int, ...]], Any] = {}
        self._buffers: List[torch.Tensor] = []

    @property
    def staged(self) -> bool:
        """True when transfers pass through pinned host buffers (``gloo``
        with the rank's buffers on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def position(self) -> Optional[int]:
        """This rank's position among the active silos, None when idle."""
        return self.active.index(self.rank) if self.rank in self.active else None

    def set_active(self, active: Sequence[int]) -> None:
        act = tuple(sorted(int(v) for v in active))
        if not act or act[0] < 0 or act[-1] >= self.world_size:
            raise ValueError(f"active silos {act} outside ranks 0..{self.world_size - 1}")
        self.active = act
        self._group("control")  # new_group is entered by every rank of the world
        self._group("data")

    def _group(self, kind: str):
        """The active ranks' ``control`` (gloo) or ``data`` (the mesh's
        backend) group; the world's own groups when every rank is active."""
        if len(self.active) == self.world_size:
            return self.control if kind == "control" else dist.group.WORLD
        key = (kind, self.active)
        if key not in self._groups:
            backend = "gloo" if kind == "control" else self.backend
            self._groups[key] = dist.new_group(list(self.active), backend=backend)
        return self._groups[key]

    # -- objects and scalars, on the gloo control group ----------------
    def broadcast(self, obj: Any, src: int = 0) -> Any:
        """``obj`` of rank ``src`` on every rank of the world."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.control)
        return box[0]

    def all_gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, by rank, on every rank of the world."""
        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.control)
        return out

    def gather_scalars(self, x: torch.Tensor) -> torch.Tensor:
        """The active silos' scalar ``x``, in silo order, as a CPU tensor;
        entered by the active ranks."""
        t = x.detach().reshape(1).to("cpu")
        out = [torch.empty_like(t) for _ in self.active]
        dist.all_gather(out, t, group=self._group("control"))
        return torch.cat(out)

    # -- tensors --------------------------------------------------------
    def _reachable(self, t: torch.Tensor) -> bool:
        return t.is_cuda if self.backend == "nccl" else t.device.type == "cpu"

    def _staging(self, count: int) -> List[torch.Tensor]:
        """``count`` byte buffers of ``chunk_bytes`` the backend can send
        from: pinned host memory under gloo, the rank's device under NCCL.
        Made once and kept for the mesh's life."""
        while len(self._buffers) < count:
            if self.backend == "gloo":
                buf = torch.empty(self.chunk_bytes, dtype=torch.uint8, pin_memory=True)
            else:
                buf = torch.empty(self.chunk_bytes, dtype=torch.uint8, device=self.device)
            self._buffers.append(buf)
        return self._buffers[:count]

    def _copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        t0 = time.perf_counter()
        dst.copy_(src)
        self.staging_s += time.perf_counter() - t0
        self.staged_bytes += src.numel() * src.element_size()

    @staticmethod
    def _view(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return buf[:like.numel() * like.element_size()].view(like.dtype)

    def exchange(self, sends: Sequence[Tuple[int, torch.Tensor]],
                 recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
        """Point-to-point transfers: each ``(rank, tensor)`` of ``sends`` to
        that rank, each of ``recvs`` from it, as one ``batch_isend_irecv``
        per chunk of ``chunk_bytes``.  Tensors are flat and contiguous; the
        peer's matching tensor has the same size and dtype, so both sides
        cut it into the same chunks, whichever of them stages.  A tensor the
        backend cannot reach (a CUDA tensor under gloo, a CPU one under
        NCCL) passes through a staging buffer."""
        tensors = [t for _, t in sends] + [t for _, t in recvs]
        peers = [r for r, _ in sends] + [r for r, _ in recvs]
        if not tensors:
            return
        if any(t.dim() != 1 or not t.is_contiguous() for t in tensors):
            raise ValueError("exchange takes flat contiguous tensors")
        self.recv_bytes += sum(t.numel() * t.element_size() for _, t in recvs)
        staged = [not self._reachable(t) for t in tensors]
        steps = [max(1, self.chunk_bytes // t.element_size()) for t in tensors]
        n_chunks = max(-(-t.numel() // step) for t, step in zip(tensors, steps))
        stage = self._staging(sum(staged))
        n_sends = len(sends)
        for c in range(n_chunks):
            ops, back = [], []
            bufs = iter(stage)
            for i, (t, step) in enumerate(zip(tensors, steps)):
                part = t[c * step:(c + 1) * step]
                if not part.numel():
                    continue
                wire = part
                if staged[i]:
                    wire = self._view(next(bufs), part)
                    if i < n_sends:
                        self._copy(wire, part)
                    else:
                        back.append((part, wire))
                ops.append(dist.P2POp(dist.isend if i < n_sends else dist.irecv, wire,
                                      peers[i]))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for part, wire in back:
                self._copy(part, wire)

    def all_gather_rows(self, row: torch.Tensor) -> torch.Tensor:
        """``[n, P]``: the active silos' rows in silo order, on this rank's
        device (the ``einsum`` lowering's all-gather), one ``all_gather``
        per chunk of ``chunk_bytes``; entered by the active ranks."""
        n = len(self.active)
        flat = row.reshape(-1)
        out = torch.empty((n, flat.numel()), dtype=row.dtype, device=row.device)
        group = self._group("data")
        self.recv_bytes += (n - 1) * flat.numel() * flat.element_size()
        staged = not self._reachable(flat)
        step = max(1, self.chunk_bytes // flat.element_size())
        for lo in range(0, flat.numel(), step):
            part = flat[lo:lo + step]
            if not staged:
                dist.all_gather(list(out[:, lo:lo + step].unbind(0)), part, group=group)
                continue
            bufs = [self._view(b, part) for b in self._staging(n + 1)]
            self._copy(bufs[n], part)
            dist.all_gather(bufs[:n], bufs[n], group=group)
            for j in range(n):
                self._copy(out[j, lo:lo + step], bufs[j])
        return out

    def gather_rows(self, row: Optional[torch.Tensor], size: int,
                    dst: int = 0) -> Optional[torch.Tensor]:
        """``[n, size]`` float32 on the CPU of rank ``dst``: the active
        silos' rows in silo order (None on the other ranks).  Every active
        rank passes its float32 row (``dst`` may be idle and pass None);
        rows move one silo at a time, in chunks."""
        out = torch.empty((len(self.active), size)) if self.rank == dst else None
        for k, src in enumerate(self.active):
            if src == dst == self.rank:
                out[k].copy_(row.reshape(-1))
            elif self.rank == dst:
                self.exchange([], [(src, out[k])])
            elif self.rank == src:
                self.exchange([(dst, row.reshape(-1))], [])
        return out


def silo_mesh(device: DeviceLike = "cuda", backend: Optional[str] = None, *,
              log: Callable[[str], None] = print) -> SiloMesh:
    """A :class:`SiloMesh` over the initialised default process group.

    ``device`` is resolved per rank (``cuda`` is ``cuda:LOCAL_RANK``);
    ``backend`` must be the group's (None takes it).  Sets the rank's CUDA
    device, makes the gloo control group, refuses NCCL with two ranks on
    one device, and under NCCL enters a barrier on every rank before any
    point-to-point call.  Every rank of the world calls it."""
    if not dist.is_initialized():
        raise RuntimeError("silo_mesh needs an initialised process group "
                           "(init_silo_mesh, torchrun or spawn)")
    rank, world = dist.get_rank(), dist.get_world_size()
    group_backend = str(dist.get_backend()).lower()
    if backend is not None and backend != group_backend:
        raise ValueError(f"backend {backend!r} asked, the process group runs {group_backend!r}")
    dev = _rank_device(device, rank)
    _check_backend(group_backend, dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    control = dist.new_group(backend="gloo")
    keys: List[Any] = [None] * world
    dist.all_gather_object(keys, _device_key(dev), group=control)
    if group_backend == "nccl" and len(set(keys)) < world:
        raise ValueError(f"nccl needs one device per rank; ranks share devices {keys}: "
                         "pass backend='gloo' to stage transfers through host memory")
    mesh = SiloMesh(rank, world, dev, group_backend, control)
    if group_backend == "nccl":
        dist.barrier(device_ids=[dev.index])
    if mesh.staged:
        log(f"[mesh] rank {rank}: gloo with buffers on {dev}: every transfer is staged "
            f"through pinned host buffers of {mesh.chunk_bytes} bytes")
    return mesh


def init_silo_mesh(rank: Optional[int] = None, world_size: Optional[int] = None,
                   init_method: str = "env://", *, backend: Optional[str] = None,
                   device: DeviceLike = "cuda",
                   log: Callable[[str], None] = print) -> SiloMesh:
    """Initialise the default process group (``backend`` None: ``nccl``
    on CUDA, ``gloo`` on the CPU) and return its :class:`SiloMesh`.
    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE``
    (``torchrun``); ``init_method`` to ``env://``."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dev = _rank_device(device, rank)
    backend = backend or default_backend(dev)
    if backend not in BACKENDS:
        raise KeyError(backend)
    _check_backend(backend, dev, rank)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return silo_mesh(dev, backend, log=log)


def _spawned(rank: int, fn: Callable, world_size: int, init_method: str, out_dir: str,
             args: tuple) -> None:
    result = fn(rank, world_size, init_method, *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args) -> List[Any]:
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
    fresh processes (the ``spawn`` start method) and return their results
    by rank.  ``init_method`` is a ``file://`` store in a temporary
    directory, for :func:`init_silo_mesh`; ``fn`` must be importable by
    name and its result picklable.  A rank that raises makes this raise,
    after every other rank is stopped."""
    with tempfile.TemporaryDirectory(prefix="silo_mesh_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        torch.multiprocessing.spawn(_spawned, args=(fn, world_size, init, tmp, args),
                                    nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
