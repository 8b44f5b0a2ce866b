"""What one rank runs in a step: FLOPs, HBM bytes, collectives, peak.

:class:`StepCounter` is a ``TorchDispatchMode``.  It sits beneath DTensor:
an op with a tensor subclass among its arguments is handed back to the
subclass (``NotImplemented``), which runs it on its local shards, and the
counter sees those local ops, the collectives DTensor issues inside an op
among them.  DTensor's sharding propagation, which runs an op once at
global shapes under a ``FakeTensorMode`` on a cache miss, is not counted:
an op that meets a fake tensor or runs under a fake mode passes uncounted.

For each counted op:

* **FLOPs** from ``torch.utils.flop_counter``'s formula registry (matrix
  products and convolutions, 2 per multiply-add), plus each kernel's cost
  from ``repro_torch.kernels.cost``, which the kernel wrappers report
  through :func:`repro_torch.kernels.cost.counted` on every route (CUDA,
  the CPU plain version, ``meta``); none of a route's own ops is counted.
* **Bytes**: each input read and each output written, whole; views,
  reshapes, allocations and other ops that move no data count nothing.
  Nothing fuses in the eager port, so this is its HBM traffic.  Bytes
  also by op or kernel name (``by_name``, the reference's
  ``bytes_by_scope``).
* **Collectives**: every ``_c10d_functional`` and ``c10d`` collective with
  its output bytes, group size and whether the group lies in one node
  (:mod:`repro_torch.roofline.analysis` names the node size and costs
  them).
* **Peak live bytes**: the storages alive at once, those of the arguments
  (params, moments, inputs) alive from the start; a storage counts from
  the op that made it until it is freed.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import cost as kernel_cost
from .analysis import NODE_SIZE

aten = torch.ops.aten

# ops that allocate or describe and move no data
_NO_DATA = {aten.empty.memory_format, aten.empty_strided.default,
            aten.empty_like.default, aten.new_empty.default,
            aten.new_empty_strided.default, aten._local_scalar_dense.default,
            aten.lift_fresh.default, aten._unsafe_view.default}
# in-place ops that write self without reading it
_WRITE_ONLY_SELF = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
                    aten.zero_.default}
# the functional collectives and c10d's, by the reference's HLO names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out":
    "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all",
}
_C10D = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None):
    """The tensors in nested tuples, lists and dicts (and NamedTuples)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _group_ranks(func, args):
    """The global ranks of the group a collective runs on: a c10d op takes
    its process group as an argument, a functional one its group's name
    last."""
    if func.namespace == "c10d":
        obj = next(a for a in args if isinstance(a, torch.ScriptObject))
        pg = dist.ProcessGroup.unbox(obj)
    else:
        from torch.distributed.distributed_c10d import _resolve_process_group
        pg = _resolve_process_group(args[-1])
    return list(dist.get_process_group_ranks(pg))


class StepCounter(TorchDispatchMode):
    """Counts what runs inside ``with StepCounter(args):``.  ``args`` is
    any tree of tensors (DTensors count their local shards) live before
    the step: params, optimizer state, inputs.  Only ops with a tensor on
    ``device`` count (the first argument's device by default): on ``meta``
    or ``cuda``, DTensor's bookkeeping on host tensors and the optimizer's
    host step do not."""

    def __init__(self, args=(), device=None):
        super().__init__()
        if device is None:
            ts = _tensors(args)
            device = _local(ts[0]).device.type if ts else "cpu"
        self.device = torch.device(device).type
        self.flops = 0
        self.bytes = 0
        self.by_name: Dict[str, int] = {}
        self.flops_by_name: Dict[str, int] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.collectives: Dict[tuple, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self.arg_bytes = 0
        self._storages: Dict[int, int] = {}
        self._quiet = 0
        self._args = args

    # ------------------------------ lifetime ---------------------------- #

    def __enter__(self):
        for t in _tensors(self._args):
            self._track(_local(t))
        self.arg_bytes = self.live
        kernel_cost._COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost._COUNTERS.remove(self)
        self._args = ()
        return super().__exit__(*exc)

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def _track(self, t):
        if type(t) not in (torch.Tensor, torch.nn.Parameter):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    # ------------------------------ kernels ----------------------------- #

    @contextlib.contextmanager
    def kernel(self, name: str, cost: kernel_cost.Cost):
        """A kernel's route: its cost added under ``name``, its own ops
        uncounted; the yielded function tracks the route's outputs."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += cost.flops
        k["bytes"] += cost.bytes
        self.flops += cost.flops
        self.bytes += cost.bytes
        self.flops_by_name[name] = self.flops_by_name.get(name, 0) + cost.flops
        self.by_name[name] = self.by_name.get(name, 0) + cost.bytes

        def track(outs):
            for t in _tensors(outs):
                self._track(t)
            return outs
        self._quiet += 1
        try:
            yield track
        finally:
            self._quiet -= 1

    # ----------------------------- dispatch ----------------------------- #

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        if (torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
                is not None or any(issubclass(t, FakeTensor) for t in types)):
            return func(*args, **kwargs)      # sharding propagation
        if any(t not in (torch.Tensor, torch.nn.Parameter) for t in types):
            return NotImplemented     # DTensor: its local ops come back
        out = func(*args, **kwargs)
        if not self._quiet:
            outs = _tensors(out)
            ins = _tensors((args, kwargs))
            if any(t.device.type == self.device for t in outs + ins):
                self._count(func, ins, outs, args, kwargs, out)
        return out

    def _count(self, func, ins, outs, args, kwargs, out):
        for t in outs:
            self._track(t)
        name = func.overloadpacket.__name__
        if func.namespace in _C10D:
            if name in _COLLECTIVES:
                self._collective(func, _COLLECTIVES[name], args, outs)
            return
        if func in _NO_DATA or func.is_view:
            return
        if func in _WRITE_ONLY_SELF:
            ins = ins[1:]
        seen, nbytes = set(), 0
        for t in ins:
            if id(t) not in seen:
                seen.add(id(t))
                nbytes += _nbytes(t)
        nbytes += sum(_nbytes(t) for t in outs)
        flops = 0
        if func.overloadpacket in flop_registry:
            flops = int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            self.flops_by_name[name] = self.flops_by_name.get(name, 0) + flops
        self.flops += flops
        self.bytes += nbytes
        self.by_name[name] = self.by_name.get(name, 0) + nbytes

    def _collective(self, func, op, args, outs):
        ranks = _group_ranks(func, args)
        g = len(ranks)
        intra = len({r // NODE_SIZE for r in ranks}) == 1
        key = (op, g, intra)
        c = self.collectives.setdefault(key, {"count": 0, "out_bytes": 0})
        c["count"] += 1
        c["out_bytes"] += sum(_nbytes(t) for t in outs)

    # ------------------------------ results ----------------------------- #

    def census(self):
        """The collectives as a list of {op, group_size, intra_node, count,
        out_bytes}."""
        return [{"op": op, "group_size": g, "intra_node": intra, **c}
                for (op, g, intra), c in sorted(self.collectives.items())]

    def totals(self) -> Dict:
        """Everything counted, as plain numbers."""
        return {"flops": self.flops, "bytes": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "by_name": dict(self.by_name),
                "flops_by_name": dict(self.flops_by_name),
                "collectives": self.census(),
                "peak_bytes": self.peak, "arg_bytes": self.arg_bytes}


def count(fn, *args, counter_args=None, device=None, **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` under a :class:`StepCounter` whose arguments
    are ``counter_args`` (``args`` by default): returns (what ``fn``
    returned, the counter's totals)."""
    with StepCounter(args if counter_args is None else counter_args,
                     device=device) as c:
        out = fn(*args, **kwargs)
    return out, c.totals()
