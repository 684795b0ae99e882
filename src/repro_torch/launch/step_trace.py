"""What one placed step does on one rank, run without data: the
counterpart of what the reference's dry run reads from XLA's compiled
program (``memory_analysis``, ``cost_analysis``, ``parse_collectives``).

``fake_group(n)`` starts a process group of ``n`` ranks in which this
process is rank 0 and every other rank is a stand-in: torch's ``"fake"``
backend, whose collectives return at once and move nothing. Under a
``FakeTensorMode`` a tensor has a shape, a dtype and a device and no
bytes, so a ``DeviceMesh`` of the production shape on that group runs a
placed step with DTensor's whole sharding propagation and every
collective it issues, and allocates nothing.

``StepTrace`` is a ``TorchDispatchMode`` that sees rank 0's local ops (a
DTensor op is let through to DTensor, as ``CommDebugMode`` lets it, and
its local ops come back to the mode) and counts:

  * memory: every storage the step makes, alive until it is freed, on
    top of the arguments' (``track_args``); ``peak`` is the most bytes
    alive at once, each storage rounded up to the card allocator's
    512-byte blocks on a CUDA device;
  * ``flops``: ``torch.utils.flop_counter``'s formulas on the local
    shapes (the kernels' custom ops have their own formulas, registered
    by their modules);
  * ``bytes``: each op's operands and results, views left out;
  * collectives: each one's output bytes and count by the reference's
    kind names (``KINDS``);
  * ``custom_ops``: how often each of the port's own ops
    (``repro_torch::…``) ran: under a ``FakeTensorMode`` each ran as its
    fake, the kernels' launching nothing.
"""
from __future__ import annotations

import contextlib
import functools
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

# the collective ops of rank 0 (functional and c10d) → the reference's
# kind names (``repro.launch.dryrun.parse_collectives``)
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "scatter_": "scatter",
    "send": "collective-permute",
    "recv_": "collective-permute",
}

# ops that read a tensor's metadata and no data
_META_OPS = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}

# where DTensor runs an op on global-shape fake tensors for its metadata
_META_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta")

_BLOCK = 512          # the CUDA caching allocator's smallest block


def collective_kind(name: str) -> str | None:
    """The reference's kind of a collective op, from its name in any of
    the spellings torch gives it (``_c10d_functional::all_reduce``,
    ``c10d_functional.all_reduce``, ``c10d.allreduce_``); None for an
    op that is not a collective."""
    base = name.replace("::", ".").split(".")
    base = [p for p in base if p not in ("default", "Tensor")]
    return KINDS.get(base[-1]) if base and any(
        p.startswith(("c10d", "_c10d")) for p in base[:-1]) else None


@contextlib.contextmanager
def fake_group(n_ranks: int):
    """A process group of ``n_ranks`` on the ``"fake"`` backend with this
    process as rank 0, destroyed on leaving. Refuses to start beside a
    group that is already up: a step traced there would run on it."""
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already "
                           "initialized; destroy it first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(x):
    """The tensors in ``x``: a tensor, or lists, tuples and dicts of
    them (an op's arguments and results), DTensors as their shards."""
    if isinstance(x, DTensor):
        yield x._local_tensor
    elif isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _storages(x) -> list:
    """(storage, its bytes) of each tensor in ``x``: on a CUDA device
    (a fake tensor's device too) rounded up to the caching allocator's
    512-byte blocks."""
    out = []
    for t in _tensors(x):
        st = t.untyped_storage()
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // _BLOCK) * _BLOCK
        out.append((st, n))
    return out


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@functools.cache
def _op_traits(func) -> tuple[bool, str | None]:
    """(whether every result of ``func`` is a view of an argument, its
    collective kind or None)."""
    rets = func._schema.returns
    view = bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)
    return view, collective_kind(func.name())


class StepTrace(TorchDispatchMode):
    """Rank 0's memory, flops, bytes and collectives of the ops run under
    it (module docstring)."""

    def __init__(self):
        super().__init__()
        self._sizes = WeakIdKeyDictionary()
        self._refs = []
        self.live = self.peak = self.args = 0
        self.flops = self.bytes = 0
        self.coll_bytes: dict[str, int] = {}
        self.coll_counts: dict[str, int] = {}
        self.custom_ops: dict[str, int] = {}
        self._skip = self._depth = 0
        self._saved = None
        self._atomic = set()        # ops that do not decompose

    def __enter__(self):
        # DTensor derives an op's global shape by running it on fake
        # tensors of the global shapes; those ops are not rank 0's work
        if not self._depth:
            prop = ShardingPropagator
            name = next(n for n in _META_PROPAGATION if hasattr(prop, n))
            orig = getattr(prop, name)

            def propagate(this, *a, **k):
                self._skip += 1
                try:
                    return orig(this, *a, **k)
                finally:
                    self._skip -= 1
            self._saved = (name, orig)
            setattr(prop, name, propagate)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            name, orig = self._saved
            setattr(ShardingPropagator, name, orig)
        return super().__exit__(*exc)

    def _freed(self, n, _ref):
        self.live -= n

    def _add(self, x) -> int:
        """Count the storages of ``x`` not yet counted as alive until
        they are freed; the bytes added."""
        added = 0
        for st, n in _storages(x):
            if st in self._sizes:
                continue
            self._sizes[st] = n
            self._refs.append(weakref.ref(st, lambda r, n=n:
                                          self._freed(n, r)))
            added += n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def track_args(self, tensors) -> int:
        """Count ``tensors``' storages (the step's placed inputs) as the
        arguments; their bytes."""
        n = self._add(tensors)
        self.args += n
        return n

    def resident(self, tensors) -> int:
        """Bytes of the distinct storages of ``tensors``."""
        seen, n = set(), 0
        for st, size in _storages(tensors):
            key = st._cdata
            if key not in seen:
                seen.add(key)
                n += size
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor desugars it into local ops and collectives, which
            # come back here
            return NotImplemented
        if self._skip or func in _META_OPS or isinstance(
                func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if (packet not in flop_registry and func not in self._atomic
                and func is not torch.ops.prim.device.default):
            # as torch's flop counter: a composite op counted by its parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._atomic.add(func)
        out = func(*args, **kwargs)
        self._add(out)
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func.namespace == "repro_torch":
            name = func._schema.name
            self.custom_ops[name] = self.custom_ops.get(name, 0) + 1
        view, kind = _op_traits(func)
        if not view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        if kind is not None:
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + _nbytes(out)
        return out

    def collectives(self) -> dict:
        """The reference's ``parse_collectives`` keys."""
        return {"bytes_by_kind": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values())}
