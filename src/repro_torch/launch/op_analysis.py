"""Roofline counts of a torch program from the aten ops it dispatches —
the port's counterpart of ``repro.launch.hlo_analysis``.

The reference parses XLA's post-optimisation HLO text and multiplies each
``while`` body by its trip count. Torch has no HLO: ``Analyzer`` is a
``TorchDispatchMode`` under which the program runs — on the meta device
(the dry run: shapes and dtypes, no storage) or on the card — and it
charges every aten op as it is dispatched, with the reference's cost
model (hlo_analysis.py:10-31), per device:

  flops (``Cost.flops``, the matmul family)
    mm, bmm, addmm, baddbmm (what ``matmul`` and ``einsum`` lower to)
                   2 * prod(out) * K, ``torch.utils.flop_counter``'s
                   ``flop_registry`` on the local shapes
    convolution    2 * prod(out) * prod(kernel) / max(out dims), the
                   reference's ``_conv_flops``
  eflops
    elementwise    prod(out) (1 flop an element; transcendentals too)
    reductions     prod of the largest operand (sum, mean, amax,
                   softmax, logsumexp, sort, cumsum, ...)
    data movement  0 (copies, casts, cat, pad, index reads and writes)

  bytes: operands + result of each aten op. Eager torch fuses nothing,
  so this is larger than the reference's fused count: it is the honest
  count of the eager program, every intermediate written and read back.
    index reads (embedding, index_select, gather, index)   ~2 * result
    writes into a slice (copy_, index_copy_, index_put_,
    scatter, slice_scatter, ...)                            ~2 * update
    views and aliases (view, expand, transpose, t, split,
    detach, ...), fresh allocations (empty)                 0

  collective bytes: the functional collectives DTensor issues (and c10d's
  in-place ones), with the ring multipliers of ``_coll_moved``
  (hlo_analysis.py:235-248) on the local tensor, n the size of the
  group the collective runs over:
    all-reduce 2(n-1)/n * size; all-gather (n-1)/n * size (the gathered
    result); reduce-scatter (n-1) * size (the scattered result);
    all-to-all (n-1)/n * size; anything else 1 * size.

Per device: an op on DTensors is not charged. The analyzer returns
``NotImplemented`` for it, as ``CommDebugMode`` does, so DTensor runs its
redistributions and the local op on this rank's shard, and those are
charged at local shapes; a replicated op is charged whole on every
device. What DTensor runs on fake tensors to propagate shardings, and ops
on no tensor of ``device`` (the mesh's coordinate tensors and the RNG
state on the host), are not the program's and are not charged.

No trip counts: eager runs every layer and microbatch, and the backward
recompute of ``torch.utils.checkpoint`` runs, and is charged, again.

Memory: ``compiled.memory_analysis()`` becomes a live-bytes count of the
same run. Argument bytes are the arguments' storages (a DTensor's local
shard), exact; every storage an op makes on ``device`` is live from its
op until it is freed (an in-place update or a view adds nothing), and the
peak is the largest sum of live storages, arguments included.

``top_contributors`` ranks by scope, where the reference ranks by XLA's
``op_name``: the innermost Python function outside torch that dispatched
the op (the port's model calls its blocks as functions, not through
``Module.forward``, so this is its module path), the autograd node in the
backward, then the aten op.

``xla_cost_analysis`` (XLA's own report) has no counterpart: there is no
compiler whose report to read (as ``compat.py``'s JAX shims have none).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_THIS_FILE = os.path.abspath(__file__)

_ZERO = {                     # views, aliases, allocations: no traffic
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand",
    "expand_as", "transpose", "t", "permute", "unsqueeze", "squeeze",
    "slice", "select", "as_strided", "split", "split_with_sizes",
    "chunk", "unbind", "detach", "alias", "narrow", "diagonal", "unfold",
    "view_as", "view_as_real", "view_as_complex", "_conj", "conj",
    "resolve_conj", "resolve_neg", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "set_",
    "_local_scalar_dense", "_wrap_tensor_autograd", "wait_tensor",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim",
    "is_same_size", "_has_compatible_shallow_copy_type", "record_stream",
}
_MOVE = {                     # data movement: bytes, no flops
    "clone", "_to_copy", "copy", "contiguous", "cat", "stack",
    "constant_pad_nd", "pad", "repeat", "repeat_interleave", "flip",
    "roll", "zeros", "ones", "full", "fill", "fill_", "zero_",
    "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full", "scalar_tensor", "arange", "lift_fresh_copy",
    "_unsafe_index", "tril", "triu", "one_hot",
}
_INDEX_READ = {"embedding", "index_select", "gather", "index", "take"}
# op -> position of the update operand
_SLICE_WRITE = {"copy_": 1, "index_copy_": 3, "index_copy": 3,
                "index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
                "scatter": 3, "scatter_": 3, "scatter_add": 3,
                "scatter_add_": 3, "scatter_reduce": 3,
                "scatter_reduce_": 3, "slice_scatter": 1,
                "select_scatter": 1, "index_add": 3, "index_add_": 3,
                "masked_scatter": 2, "masked_scatter_": 2}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "argmax", "argmin", "linalg_vector_norm", "norm", "var", "std",
    "var_mean", "std_mean", "prod", "cumsum", "cumprod", "sort", "topk",
    "any", "all", "nll_loss_forward", "nll_loss_backward", "aminmax",
}
_CONV = {"convolution", "_convolution", "convolution_backward",
         "cudnn_convolution", "convolution_overrideable"}
_MATMUL = {p for p in flop_registry
           if isinstance(p, torch._ops.OpOverloadPacket)
           and p._qualified_op_name.split("::")[-1] not in _CONV}
# collective -> (reference name, ring multiplier of its size)
_COLL = {
    "all_reduce": ("all-reduce", lambda n: 2.0 * (n - 1) / n),
    "all_reduce_": ("all-reduce", lambda n: 2.0 * (n - 1) / n),
    "allreduce_": ("all-reduce", lambda n: 2.0 * (n - 1) / n),
    "all_gather_into_tensor": ("all-gather", lambda n: (n - 1) / n),
    "all_gather_into_tensor_out": ("all-gather", lambda n: (n - 1) / n),
    "_allgather_base_": ("all-gather", lambda n: (n - 1) / n),
    "reduce_scatter_tensor": ("reduce-scatter", lambda n: float(n - 1)),
    "_reduce_scatter_base_": ("reduce-scatter", lambda n: float(n - 1)),
    "all_to_all_single": ("all-to-all", lambda n: (n - 1) / n),
    "alltoall_base_": ("all-to-all", lambda n: (n - 1) / n),
    "broadcast": ("collective-permute", lambda n: 1.0),
    "broadcast_": ("collective-permute", lambda n: 1.0),
}
# in-place c10d collectives: the operand that holds the result
_COLL_RESULT_ARG = {"allreduce_": 0, "_allgather_base_": 0,
                    "_reduce_scatter_base_": 0, "alltoall_base_": 0,
                    "broadcast_": 0}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0       # matmul-family / convolution flops
    eflops: float = 0.0      # elementwise / reduction flops
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll: dict = dataclasses.field(default_factory=dict)


def _name(func) -> str:
    return func._overloadpacket._qualified_op_name.split("::")[-1]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _conv_flops(out: torch.Tensor, kernel: torch.Tensor) -> float:
    feat = max(out.shape) if out.dim() else 1
    return 2.0 * out.numel() * max(kernel.numel() // max(feat, 1), 1)


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs over: its
    ``group_size`` or ``group_name`` (functional collectives) or its
    ``ProcessGroup`` (c10d's)."""
    vals = dict(zip((a.name for a in func._schema.arguments), args))
    vals.update(kwargs)
    if "group_size" in vals:
        return int(vals["group_size"])
    if "group_name" in vals:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(vals["group_name"]).size()
    return int(vals["process_group"].size())


def local_tensors(tree) -> list[torch.Tensor]:
    """Every tensor in ``tree`` (dicts, lists, tuples, named tuples and
    dataclasses such as ``OptState`` and ``QTensor``), a DTensor as its
    local shard."""
    out: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(tree)
    return out


class Analyzer(TorchDispatchMode):
    """Counts the program run under it (``with Analyzer(device) as a:``)
    on ``device`` (default: every device). ``a.cost`` is the total
    ``Cost``; ``a.analyze()`` the reference's dict; ``a.contrib`` scope
    -> [flops, bytes, coll_bytes]; ``a.op_counts`` op name -> calls;
    ``a.memory(args, out)`` the memory analysis. ``args`` passed here
    are live from the start (their bytes are the argument bytes)."""

    def __init__(self, device=None, args=None):
        super().__init__()
        self.device = None if device is None else torch.device(device)
        self.cost = Cost()
        self.contrib: dict[str, list[float]] = {}
        self.n_ops = 0
        self.op_counts: dict[str, int] = {}
        self._live: dict[int, tuple[int, Any]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._arg_storages: set[int] = set()
        if args is not None:
            for t in local_tensors(args):
                if self._on(t):
                    self._arg_storages.add(self._track(t))
            self.argument_bytes = self.live_bytes

    # --- what is the program's ---------------------------------------------
    def _on(self, t: torch.Tensor) -> bool:
        if self.device is None:
            return True
        d = t.device
        return d.type == self.device.type and (
            self.device.index is None or d.index == self.device.index)

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            n = st.nbytes()
            live = self._live

            def free(_ref, key=key, n=n, owner=weakref.ref(self)):
                a = owner()
                if a is not None and key in live:
                    del live[key]
                    a.live_bytes -= n
            self._live[key] = (n, weakref.ref(st, free))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return key

    # --- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fake = torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None
        if not fake and any(t is not torch.Tensor
                            and t is not torch.nn.Parameter
                            and not issubclass(
                                t, torch._subclasses.FakeTensor)
                            for t in types):
            # DTensor (and the collectives' async wrappers): let the
            # subclass unwrap to its local tensors, then count those
            return NotImplemented
        out = func(*args, **kwargs)
        if fake or any(issubclass(t, torch._subclasses.FakeTensor)
                       for t in types):
            return out              # DTensor's sharding propagation
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if self.device is not None and not any(
                self._on(t) for t in ins + outs):
            return out
        for t in ins + outs:
            if self._on(t):
                self._track(t)
        self._charge(func, args, kwargs, ins, outs)
        return out

    def _charge(self, func, args, kwargs, ins, outs):
        name = _name(func)
        dins = [t for t in ins if self._on(t)]
        douts = [t for t in outs if self._on(t)]
        fl = efl = cb = 0.0
        if name in _ZERO or (func.is_view and name not in _MOVE):
            by = 0.0
        elif name in _COLL:
            ref, mult = _COLL[name]
            res = douts if name not in _COLL_RESULT_ARG else [
                t for t in tree_flatten(args[_COLL_RESULT_ARG[name]])[0]
                if isinstance(t, torch.Tensor)]
            size = float(sum(_nbytes(t) for t in res))
            cb = mult(_group_size(func, args, kwargs)) * size
            by = float(sum(_nbytes(t) for t in dins + douts))
            slot = self.cost.coll.setdefault(ref, {"count": 0.0,
                                                   "bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += cb
        elif name in _INDEX_READ:
            by = 2.0 * sum(_nbytes(t) for t in douts)
        elif name in _SLICE_WRITE:
            pos = _SLICE_WRITE[name]
            upd = args[pos] if len(args) > pos else None
            if isinstance(upd, torch.Tensor):
                by = 2.0 * _nbytes(upd)
            else:                   # a scalar fill: the index's size
                by = 2.0 * sum(_nbytes(t) for t in douts)
        else:
            by = float(sum(_nbytes(t) for t in dins + douts))
            if func._overloadpacket in _MATMUL:
                fl = float(flop_registry[func._overloadpacket](
                    *args, out_val=outs[0] if len(outs) == 1 else outs))
            elif name in _CONV and len(args) > 1:
                fl = _conv_flops(outs[0], args[1])
            elif name in _REDUCE:
                efl = float(max((t.numel() for t in dins), default=0))
            elif name not in _MOVE:
                efl = float(sum(t.numel() for t in douts))
        self.n_ops += 1
        self.op_counts[name] = self.op_counts.get(name, 0) + 1
        self.cost.flops += fl
        self.cost.eflops += efl
        self.cost.bytes += by
        self.cost.coll_bytes += cb
        key = f"{_scope()}/{name}"
        slot = self.contrib.setdefault(key, [0.0, 0.0, 0.0])
        slot[0] += fl + efl
        slot[1] += by
        slot[2] += cb

    # --- results ------------------------------------------------------------
    def analyze(self) -> dict[str, Any]:
        """The reference's ``analyze`` keys: per-device flops, HBM bytes,
        collective bytes and the per-collective breakdown."""
        c = self.cost
        return {"flops_per_dev": c.flops + c.eflops,
                "bytes_per_dev": c.bytes,
                "collective_bytes_per_dev": c.coll_bytes,
                "collectives": {k: {"count": v["count"], "bytes": v["bytes"]}
                                for k, v in sorted(c.coll.items())}}

    def top_contributors(self, n: int = 15, key: str = "bytes"
                         ) -> list[tuple[str, list[float]]]:
        """Largest contributors by 'flops' | 'bytes' | 'coll'."""
        idx = {"flops": 0, "bytes": 1, "coll": 2}[key]
        return sorted(self.contrib.items(), key=lambda kv: -kv[1][idx])[:n]

    def memory(self, out=None) -> dict[str, int]:
        """``compiled.memory_analysis()``'s fields for this run:
        arguments, the outputs ``out`` (their distinct storages), those
        of them that are argument storages updated in place (alias), the
        peak of live bytes, and temp = the rest of the peak, so that
        peak = argument + output + temp - alias as in the reference's
        record."""
        seen: set[int] = set()
        outb = alias = 0
        for t in local_tensors(out):
            if not self._on(t):
                continue
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            outb += st.nbytes()
            if st._cdata in self._arg_storages:
                alias += st.nbytes()
        peak = max(self.peak_bytes, self.argument_bytes + outb - alias)
        return {"argument_bytes": self.argument_bytes, "output_bytes": outb,
                "temp_bytes": peak - self.argument_bytes - outb + alias,
                "alias_bytes": alias, "peak_bytes": peak}


def _scope() -> str:
    """The innermost Python function outside torch (and this module)
    that dispatched the op, with the autograd node in the backward."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_TORCH_DIR) or fn == _THIS_FILE
                or fn.startswith("<")):
            break
        f = f.f_back
    where = "" if f is None else (
        f"{f.f_globals.get('__name__', '?')}.{f.f_code.co_qualname}")
    node = torch._C._current_autograd_node()
    return f"{where}/{node.name()}" if node is not None else where


def count(fn, *args, device=None, **kwargs) -> tuple[Analyzer, Any]:
    """Run ``fn(*args, **kwargs)`` under an ``Analyzer`` on ``device``
    (``args`` are its arguments for the memory analysis); returns the
    analyzer and ``fn``'s result."""
    a = Analyzer(device, args=(args, kwargs))
    with a:
        out = fn(*args, **kwargs)
    return a, out


def analyze(fn, *args, device=None, **kwargs) -> dict[str, Any]:
    """Top level: per-device flops / HBM bytes / collective bytes and
    the per-collective breakdown of ``fn(*args, **kwargs)``."""
    return count(fn, *args, device=device, **kwargs)[0].analyze()


def top_contributors(fn, *args, n: int = 15, key: str = "bytes",
                     device=None, **kwargs
                     ) -> list[tuple[str, list[float]]]:
    """Largest contributors of ``fn(*args, **kwargs)`` by 'flops' |
    'bytes' | 'coll' — the dry-run profiler."""
    return count(fn, *args, device=device, **kwargs)[0].top_contributors(
        n, key)
