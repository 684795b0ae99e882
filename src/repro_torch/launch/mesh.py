"""Source meshes over ``torch.distributed`` (port of ``make_source_mesh``
and ``n_chips`` of ``repro.launch.mesh``).

The reference drives its ``("sources",)`` mesh from one process through
``shard_map``. The port is SPMD: every rank of a process group runs the
same program on the same inputs, works on its own source lanes and
meets the other ranks at explicit collectives. ``SourceMesh`` is that
group seen as a 1-D mesh: ``mesh.shape["sources"]`` is the rank count H
and ``mesh.index`` this rank's place on the axis, so code reads like the
reference's ``mesh.shape[SOURCES_AXIS]``.

The collectives go through the mesh (``all_reduce``, ``all_gather``,
``broadcast``), which counts them by kind in ``mesh.collectives``. On a
gloo group a CUDA tensor is staged through the host explicitly, one
copy there and one back, each counted in ``mesh.host_copies``: gloo is
the backend of several ranks that share one card, where NCCL refuses
two ranks on one device. The backend is never changed behind the
caller's back.

``spawn_ranks`` starts H ranks as processes (start method "spawn", a
``FileStore`` under ``$TMPDIR``, no network) and returns what each
rank's program returned: the counterpart of the reference's simulated
hosts (``--xla_force_host_platform_device_count``). ``run_all`` runs
several rank programs in one spawn; ``route`` and ``engine_chaos`` are
the programs ``chip_smoke.py`` and the CPU tests give it:

    spawn_ranks(run_all, 4, [(route, dict(keys=keys, n_bins=64,
                                          n_sources=8))], device="cpu")
"""
from __future__ import annotations

import collections
import contextlib
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.backend import resolve_device

SOURCES_AXIS = "sources"


def _rank_device(device) -> torch.device:
    """``device`` with its index: a rank's tensors must compare equal to
    the kernels' checks (``cuda`` and ``cuda:0`` differ as devices)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _default_backend(device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class SourceMesh:
    """The ranks of the initialised ``torch.distributed`` group as a 1-D
    mesh whose one axis is ``"sources"``. ``device`` is where this rank's
    tensors live."""

    def __init__(self, device="cuda", store_path: str | None = None):
        if not dist.is_initialized():
            raise RuntimeError("SourceMesh needs an initialised process "
                               "group (make_source_mesh or spawn_ranks)")
        self.device = _rank_device(device)
        self.backend = dist.get_backend()
        self.size = dist.get_world_size()
        self.index = dist.get_rank()
        self.shape = {SOURCES_AXIS: self.size}
        self.collectives = collections.Counter()
        self.host_copies = 0
        self._store_path = store_path

    @property
    def group(self):
        """The initialised group, looked up at each use: a mesh holds no
        reference to it, so ``destroy_process_group`` frees it. A group
        object that outlives its destruction is freed only at interpreter
        exit, if at all, and there gloo's teardown can abort the process
        ("terminate called without an active exception")."""
        return dist.group.WORLD

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous buffer of ``t`` the backend takes, which the
        collective may overwrite: a host copy on gloo for a CUDA tensor."""
        if self.backend == "gloo" and t.is_cuda:
            self.host_copies += 1
            return t.cpu()
        return t.contiguous().clone()

    def _unstage(self, buf: torch.Tensor) -> torch.Tensor:
        if buf.device != self.device:
            self.host_copies += 1
            return buf.to(self.device)
        return buf

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        self.collectives["all_reduce"] += 1
        buf = self._stage(t)
        dist.all_reduce(buf, group=self.group)
        return self._unstage(buf)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: [H, *t.shape]."""
        self.collectives["all_gather"] += 1
        buf = self._stage(t)
        out = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(out, buf, group=self.group)
        return self._unstage(torch.stack(out))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (a new tensor)."""
        self.collectives["broadcast"] += 1
        buf = self._stage(t)
        dist.broadcast(buf, src=src, group=self.group)
        return self._unstage(buf)

    def close(self) -> None:
        """Destroy the group and remove its store file if
        ``make_source_mesh`` initialised it."""
        if self._store_path is None:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        if os.path.exists(self._store_path):
            os.unlink(self._store_path)
        self._store_path = None


def make_source_mesh(n_hosts: int | None = None, *, backend: str | None = None,
                     device="cuda") -> SourceMesh:
    """1-D mesh whose one ``sources`` axis carries the serving runtime's
    source lanes (``repro_torch.kernels.mesh``, ``repro_torch.serve.
    mesh``) over the initialised process group, every rank of it. Where no
    group is initialised, initialises one rank (NCCL for the card, gloo
    for the CPU, unless ``backend`` says) over a ``FileStore`` under
    ``$TMPDIR``; several ranks are started with ``spawn_ranks``. Raises if
    ``n_hosts`` or ``backend`` disagree with the group."""
    dev = _rank_device(device)
    path = None
    if not dist.is_initialized():
        if n_hosts not in (None, 1):
            raise ValueError(f"no process group for {n_hosts} hosts: start "
                             "the ranks with launch.mesh.spawn_ranks")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        fd, path = tempfile.mkstemp(prefix="repro_torch_store_")
        os.close(fd)
        backend = backend or _default_backend(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(path, 1), rank=0, world_size=1,
            device_id=dev if backend == "nccl" else None)
    elif n_hosts is not None and n_hosts != dist.get_world_size():
        raise ValueError(f"n_hosts={n_hosts}, but the process group has "
                         f"{dist.get_world_size()} ranks")
    mesh = SourceMesh(device=dev, store_path=path)
    if backend is not None and backend != mesh.backend:
        raise ValueError(f"backend={backend!r}, but the process group runs "
                         f"{mesh.backend!r}")
    return mesh


def n_chips(mesh) -> int:
    """Devices of a source mesh, a ``DeviceMesh`` or a ``ShapeMesh``."""
    if isinstance(mesh, DeviceMesh):
        return mesh.size()
    return mesh.size


# -- the model mesh ------------------------------------------------------------

class ShapeMesh:
    """A mesh's shape and nothing else: ``shape`` (axis name → size),
    ``axis_names`` and ``size``. The placement rules read only these, so
    it stands for the production meshes, whose 256 or 512 ranks no
    process here owns (the counterpart of JAX's ``AbstractMesh``)."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))

    def __repr__(self):
        return f"ShapeMesh({self.shape})"


def mesh_shape(mesh) -> dict:
    """Axis name → size of a ``DeviceMesh`` or a ``ShapeMesh``, in the
    mesh's order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh) -> tuple:
    """The combined batch-sharding axes of this mesh."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's production shapes, (16, 16) ``("data", "model")``
    or (2, 16, 16) ``("pod", "data", "model")``, as a ``ShapeMesh``
    (``launch/dryrun.py`` places every cell on them)."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"),
                    device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the initialised process group
    (its world size must be the mesh's size); each rank's tensors live on
    ``device`` (a bare ``"cuda"``: the rank's current card). Where no
    group is initialised, starts one rank (NCCL on the card, gloo on the
    CPU, a ``FileStore`` under ``$TMPDIR``), which leaving
    ``enter_mesh(mesh)`` destroys."""
    dev = _rank_device(device)
    path = None
    n = int(np.prod(shape))
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"no process group for a {shape} mesh: start "
                             "the ranks with launch.mesh.spawn_ranks")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        fd, path = tempfile.mkstemp(prefix="repro_torch_store_")
        os.close(fd)
        backend = _default_backend(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(path, 1), rank=0, world_size=1,
            device_id=dev if backend == "nccl" else None)
    elif dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, but the process "
                         f"group has {dist.get_world_size()}")
    mesh = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)
    mesh.store_path = path
    return mesh


@contextlib.contextmanager
def enter_mesh(mesh):
    """Install ``mesh`` as the ambient mesh (a ``DeviceMesh``'s own
    context); on leaving, destroy the one-rank group ``make_smoke_mesh``
    started for it. A ``ShapeMesh`` has nothing to install."""
    if not isinstance(mesh, DeviceMesh):
        yield mesh
        return
    try:
        with mesh:
            yield mesh
    finally:
        path = getattr(mesh, "store_path", None)
        if path is not None:
            mesh.store_path = None
            if dist.is_initialized():
                dist.destroy_process_group()
            if os.path.exists(path):
                os.unlink(path)


def _rank_main(rank: int, n_ranks: int, tmp: str, backend, device: str,
               fn, args) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)``, write
    its result for the parent, then leave the group with the others.

    The rank meets every other at a barrier before it destroys the group,
    so none tears its gloo context down while a peer is still in a
    collective, and none leaves while a peer's ``fn`` has raised: such a
    peer never reaches the barrier, and ``spawn_ranks`` stops the ranks
    waiting there. A rank whose ``fn`` raises leaves the group as it is
    (a peer may wait in a collective it will not join) and fails with
    its traceback."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or _default_backend(dev),
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 n_ranks),
                            rank=rank, world_size=n_ranks)
    out = fn(SourceMesh(device=dev), *args)
    part = os.path.join(tmp, f"rank{rank}.part")
    with open(part, "wb") as f:
        pickle.dump(out, f)
    os.replace(part, os.path.join(tmp, f"rank{rank}.pkl"))
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(fn, n_ranks: int, *args, backend: str | None = None,
                device="cuda") -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` ranks, each a process started
    with "spawn", and return their results in rank order. ``fn`` must be
    importable by the children (a module-level function) and its result
    picklable. Rank r's device is ``device``, or with a bare ``"cuda"``
    card ``r % device_count()``; the backend defaults to NCCL for the card
    and gloo for the CPU (several ranks on one card need gloo). A rank
    that raises fails the call with its traceback
    (``torch.multiprocessing.ProcessRaisedException``) and the others are
    stopped."""
    if torch.device(device).type == "cuda":
        resolve_device(device)          # no card: raise here, not n times
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        mp.start_processes(_rank_main,
                           args=(n_ranks, tmp, backend, str(device), fn, args),
                           nprocs=n_ranks, join=True, start_method="spawn")
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# -- rank programs -------------------------------------------------------------

def run_all(mesh: SourceMesh, cases) -> dict:
    """Run each ``(program, kwargs)`` of ``cases`` in turn on this rank
    (one spawn for many checks): their results and the wall seconds of
    each, in order."""
    results, seconds = [], []
    for fn, kw in cases:
        t0 = time.perf_counter()
        results.append(fn(mesh, **kw))
        seconds.append(time.perf_counter() - t0)
    return dict(results=results, seconds=seconds)


def _sync(mesh: SourceMesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier(group=mesh.group)


def route(mesh: SourceMesh, keys, n_bins: int, n_sources: int, *,
          sync_every: int = 1, block: int = 128, eps: float = 0.05,
          chunk: int = 8, cuts=(), timed_reps: int = 0) -> dict:
    """``mesh_porc_multisource`` over ``keys`` (host int32), cut at
    ``cuts`` into calls that carry the state. Returns the assignment, the
    merged base, the gathered lanes, ticks and routed; this rank's kernel
    launches and the mesh's collectives and host copies over those calls;
    with ``timed_reps`` the seconds of that many more whole-stream calls,
    each from the empty state, the ranks meeting at a barrier before and
    after each."""
    from repro_torch.kernels.mesh import gather_delta, mesh_porc_multisource
    from repro_torch.kernels.porc_snapshot import porc_multisource_scan
    dev = mesh.device
    k = torch.from_numpy(np.ascontiguousarray(keys, np.int32)).to(dev)
    kw = dict(n_sources=n_sources, sync_every=sync_every, block=block,
              eps=eps, chunk=chunk)
    launches0 = porc_multisource_scan.launches
    mesh.collectives.clear()
    copies0 = mesh.host_copies
    bounds = [0, *cuts, len(keys)]
    parts, st = [], None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        a, st = mesh_porc_multisource(k[lo:hi], n_bins, mesh, state=st, **kw)
        parts.append(a)
    out = dict(launches=porc_multisource_scan.launches - launches0,
               collectives=dict(mesh.collectives),
               host_copies=mesh.host_copies - copies0)
    out.update(assign=torch.cat(parts).cpu().numpy(),
               base=st.base.cpu().numpy(),
               delta=gather_delta(st, mesh).cpu().numpy(),
               ticks=int(st.ticks), routed=float(st.routed),
               lanes=tuple(st.delta.shape))
    seconds = []
    for _ in range(timed_reps):
        _sync(mesh)
        t0 = time.perf_counter()
        mesh_porc_multisource(k, n_bins, mesh, **kw)
        _sync(mesh)
        seconds.append(time.perf_counter() - t0)
    out["seconds"] = seconds
    return out


def _engine(mesh: SourceMesh, n: int = 4, **kw):
    """A ``ServingEngine`` of ``n`` echo replicas over
    ``MeshCGRequestRouter(n, alpha=4, n_sources=8)`` on ``mesh``."""
    from repro_torch.serve import MeshCGRequestRouter, ServingEngine
    router = MeshCGRequestRouter(
        n_replicas=n, alpha=4, n_sources=8, capacity_weighted=True,
        mesh=mesh, device=str(mesh.device))
    return ServingEngine([lambda b: b for _ in range(n)], router,
                         max_batch=8, **kw)


def _served(eng) -> int:
    return sum(r.served for r in eng.replicas)


def engine_chaos(mesh: SourceMesh, ticks: int = 30) -> dict:
    """Async submit under a kill-one at tick 6 (replica 2, heartbeat
    timeout 2): (submitted, served, in flight) after every submit and
    every step, then a drain; the drain's end state, and the replica ids
    of every admitted batch."""
    from repro_torch.runtime.chaos import ChaosSchedule
    eng = _engine(mesh, 4, chaos=ChaosSchedule.kill_one(2, at=6),
                  heartbeat_timeout_steps=2, async_submit=True)
    admitted = []
    finalize = eng.router.finalize_batch

    def record(assign_vw):
        admitted.append(finalize(assign_vw))
        return admitted[-1]

    eng.router.finalize_batch = record
    rng = np.random.default_rng(5)
    trace = []
    for _ in range(ticks):
        keys = rng.zipf(1.3, size=32).astype(np.int32) % 512
        eng.submit_batch(keys, list(keys))
        trace.append((eng.submitted, _served(eng), eng.in_flight))
        eng.step()
        trace.append((eng.submitted, _served(eng), eng.in_flight))
    drain = 0
    while eng.in_flight and drain < 300:
        eng.step()
        drain += 1
    return dict(trace=trace, drain=drain, in_flight=eng.in_flight,
                dropped=eng.dropped, evacuations=eng.evacuations,
                submitted=eng.submitted, served=_served(eng),
                per_replica=[r.served for r in eng.replicas],
                admitted=admitted, owner=eng.router.vw_owner)
