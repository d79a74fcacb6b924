"""Ranks, process groups and collectives for data-parallel training (port of
parallel/mesh.py).

The JAX package runs one SPMD program over a named device mesh and lets
XLA's partitioner insert the collectives.  Here one rank is one process per
device, joined by ``torch.distributed``: NCCL for CUDA devices, gloo for the
CPU.  The backend follows from the device (``backend_for``); a caller that
wants another one names it, and nothing tries one backend and falls back to
another.  A ``Mesh`` is this process's handle: its rank, the world size, its
device and backend, and the collectives the data-parallel code calls, each
counted in ``Mesh.collectives``.

Ranks come from one of two launchers: ``torchrun`` (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT in the environment) or ``launch``,
which starts N workers with ``torch.multiprocessing`` (spawn) joined over
``tcp://localhost:<free port>``.  ``create_mesh(n)`` finds the group either
made.  A mesh of more ranks than visible cards raises (JAX's ``create_mesh``
quietly takes fewer devices).
"""

from __future__ import annotations

import dataclasses
import io
import os
import socket

import torch
import torch.distributed as dist

from microwakeword_tpu_torch.device import resolve_device


def backend_for(device) -> str:
    """The process-group backend of ``device``: NCCL on CUDA, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def device_count(device=None) -> int:
    """Devices a mesh over ``device``'s type may span: the visible cards;
    the CPU is one device."""
    return torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1


def auto_mesh(batch_size: int, min_devices: int = 2, device=None) -> int | None:
    """The largest device count that divides ``batch_size`` (the sharded step
    needs divisibility), or None when that count is below ``min_devices``:
    one device runs the solo step.  On one card ``auto`` is therefore solo."""
    n = device_count(device)
    while n >= max(min_devices, 1) and batch_size % n:
        n -= 1
    return n if n >= max(min_devices, 1) else None


def mesh_size(flag: str, divisor: int, device=None) -> int | None:
    """The rank count of a ``--mesh`` flag: 'off' -> None (one device),
    'auto' -> ``auto_mesh(divisor)``, N -> N (1 -> None).  N must divide
    ``divisor`` (the batch, or a sweep's member count) and, on CUDA, may not
    exceed the visible cards."""
    if flag == "off":
        return None
    if flag == "auto":
        return auto_mesh(divisor, device=device)
    n = int(flag)
    if n < 1:
        raise ValueError(f"--mesh {flag}: a mesh needs at least one device")
    if resolve_device(device).type == "cuda" and n > device_count(device):
        raise ValueError(f"--mesh {n}: only {device_count(device)} CUDA device(s) are visible")
    if divisor % n:
        raise ValueError(f"--mesh {n} does not divide {divisor} (the batch or member count)")
    return n if n > 1 else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward is the same sum: every rank's loss
    depends on the reduced value, so each input's gradient is the sum of the
    ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone()), None


@dataclasses.dataclass
class Mesh:
    """This process's place in a data-parallel group of ``size`` ranks.

    ``collectives`` counts the collectives its methods have launched.
    """

    size: int
    rank: int
    device: torch.device
    backend: str
    collectives: int = 0

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes checkpoints, metrics and artifacts."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows, [r n/D, (r+1) n/D)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce of ``x`` (on this rank's device); returns x."""
        self.collectives += 1
        dist.all_reduce(x, op=op)
        return x

    def all_reduce_autograd(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, differentiable: one all-reduce in
        the forward pass and one in the backward pass."""
        return _AllReduceSum.apply(x, self)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` [n, ...] concatenated in rank order, [D n, ...]:
        one all-gather.  gloo's CUDA path carries only broadcast and
        all-reduce, so gloo on CUDA tensors (two ranks sharing one card)
        all-reduces zero-padded rows instead, which is as exact: each entry
        adds zeros to one value."""
        n = x.shape[0]
        if self.backend == "gloo" and x.is_cuda:
            out = x.new_zeros((self.size * n,) + tuple(x.shape[1:]))
            out[self.rank * n : (self.rank + 1) * n] = x
            return self.all_reduce(out)
        out = x.new_empty((self.size * n,) + tuple(x.shape[1:]))
        self.collectives += 1
        dist.all_gather([out[r * n : (r + 1) * n] for r in range(self.size)], x.contiguous())
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In-place broadcast of rank ``src``'s contiguous ``x``; returns x.
        Its bytes travel (as uint8), so every dtype goes, int16 included,
        which neither gloo nor NCCL reduces."""
        self.collectives += 1
        dist.broadcast(x.view(torch.uint8) if x.dim() else x, src=src)
        return x

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        self.collectives += 1
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        self.collectives += 1
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        """Returns once every rank has reached it (an all-reduce the host
        waits for)."""
        self.all_reduce(torch.zeros(1, device=self.device)).cpu()


def _rank_device(device, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    return dev


def init_mesh(size: int, rank: int, device=None, backend: str | None = None,
              init_method: str = "env://", local_rank: int | None = None) -> Mesh:
    """Joins the process group of ``size`` ranks as ``rank`` and returns its
    Mesh.  ``device`` None is the card: cuda:``local_rank`` (default
    ``rank``); an indexed device is taken as given.  ``backend`` None is
    ``backend_for(device)``."""
    dev = _rank_device(device, rank if local_rank is None else local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or backend_for(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank)
    return Mesh(size, rank, dev, backend)


def create_mesh(n_devices: int, device=None) -> Mesh:
    """The Mesh of this process in a group of ``n_devices`` ranks: the group
    already joined (a ``launch`` worker), or the one ``torchrun`` describes
    in the environment.  Raises when there is neither or the sizes differ."""
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = Mesh(size, rank, dev, backend)
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        mesh = init_mesh(int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device,
                         local_rank=int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    else:
        raise ValueError(
            f"a mesh of {n_devices} devices needs a process group of {n_devices} ranks: run "
            "under torchrun, or start the ranks with parallel.mesh.launch")
    if mesh.size != n_devices:
        raise ValueError(f"a mesh of {n_devices} devices in a process group of {mesh.size} ranks")
    return mesh


def resolve_mesh(mesh, device=None) -> Mesh | None:
    """A ``mesh`` argument: None or 1 -> None (solo); a rank count -> its
    ``create_mesh``; a Mesh as given."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return create_mesh(int(mesh), device) if int(mesh) > 1 else None


def in_process_group() -> bool:
    """True in a rank that ``launch`` or ``torchrun`` started."""
    return dist.is_initialized() or ("WORLD_SIZE" in os.environ and "RANK" in os.environ)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, size: int, device: str, backend, init_method: str, threads: int,
               queue, fn, args, kwargs) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_mesh(size, rank, device, backend, init_method)
    try:
        out = fn(*args, **kwargs)
        buf = io.BytesIO()
        torch.save(out, buf)
        queue.put((rank, buf.getvalue()))
    finally:
        dist.destroy_process_group()


def launch(fn, size: int, device=None, *args, backend: str | None = None, **kwargs) -> list:
    """Runs ``fn(*args, **kwargs)`` on ``size`` new ranks on ``device``'s
    type and returns their results in rank order (each through ``torch.save``
    bytes, tensors mapped to the CPU).  The ranks are spawned processes
    joined over ``tcp://localhost:<free port>`` with ``backend`` (None:
    ``backend_for(device)``); on CUDA rank r takes card r, or every rank
    the card ``device`` names by its index.  CPU ranks split
    this process's torch threads.  A rank that raises stops the others, and
    its error is raised here."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and size > device_count(dev):
        raise ValueError(f"{size} ranks but only {device_count(dev)} CUDA device(s) are visible")
    threads = max(1, torch.get_num_threads() // size) if dev.type == "cpu" else 0
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(size, str(dev), backend, f"tcp://localhost:{free_port()}", threads,
                          queue, fn, args, kwargs),
        nprocs=size, join=False, start_method="spawn")
    results = {}

    def drain():
        while not queue.empty():
            rank, data = queue.get()
            results[rank] = torch.load(io.BytesIO(data), map_location="cpu", weights_only=False)

    # drain while joining: a rank blocks on a result larger than the pipe
    while not ctx.join(timeout=0.2):
        drain()
    drain()
    return [results[r] for r in range(size)]
