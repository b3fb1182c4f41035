"""Fake-tensor op traces and their walkers — the port's counterpart of the
reference's ``analysis/jaxpr_utils.py`` and of ``jax.make_jaxpr``.

:func:`trace` runs a function under ``FakeTensorMode`` (every tensor has
a shape, a dtype, a device and strides, and no data; fake ``"cuda"``
tensors work on a build without CUDA) and a recording
``TorchDispatchMode``. Nothing executes on a device: each kernel is a
registered op (``kernels/_ops.py``) whose fake implementation allocates
what the launch allocates and notes the launch's plan.

The trace holds one :class:`OpRecord` per op: its name, the shapes,
dtypes and devices of its inputs and outputs, the tensors it writes in
place, its flops (``torch.utils.flop_counter``'s formulas, and each kernel
op's own) and, for a kernel op, the plan the real launch would use. An op
whose result depends on the data (``.item()`` of a fake tensor, the shape
of ``nonzero``) raises under fake mode; the trace records it as a host
sync and goes on with a stand-in result. The trace also tracks the live
fake storages (by weak reference), so it knows the bytes of the
arguments, the outputs and the peak of what the function allocates.

A DTensor op is not recorded itself: the mode lets DTensor run it and
records the local ops and the ``_c10d_functional`` collectives it issues,
with per-rank shapes.

The walkers (:func:`iter_ops`, :func:`op_label`,
:func:`float_shapes_outside_kernels`, :func:`find_kernel_ops`) never look
inside a kernel op, as the reference's never descend into a
``pallas_call`` body: the tiles in shared memory are the point of the
kernel.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _ops

__all__ = ["OpRecord", "Trace", "trace", "iter_ops", "op_label",
           "float_shapes_outside_kernels", "find_kernel_ops", "is_kernel",
           "tensor_leaves", "FakeMode", "fake_mode", "fake_tree", "KERNEL_NS",
           "TRANSCENDENTAL"]

_ops.register_all()               # a trace sees every kernel's op
KERNEL_NS = _ops.NAMESPACE + "."
# ops whose every output element is one transcendental function (XLA's
# "transcendentals": exp, log, tanh and kin)
TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sigmoid",
    "tanh", "rsqrt", "sqrt", "sin", "cos", "erf", "pow", "_softmax",
    "_log_softmax", "silu", "gelu", "softplus"))
# argument names of a mutating op that select where it writes, not what
_INDEX_ARGS = ("index", "indices", "mask")

Meta = Tuple[Tuple[int, ...], torch.dtype, str]      # shape, dtype, device


def _meta(t: torch.Tensor) -> Meta:
    return tuple(int(d) for d in t.shape), t.dtype, t.device.type


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_leaves(tree) -> List[torch.Tensor]:
    """Every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


def _storage(t: torch.Tensor) -> Optional[StorageWeakRef]:
    try:
        return StorageWeakRef(t.untyped_storage())
    except (RuntimeError, NotImplementedError):    # a subclass: no storage
        return None


@dataclasses.dataclass
class OpRecord:
    """One op of a trace. ``writes`` lists, for each tensor the op writes
    in place, ``(storage key, shape, dtype, [dtypes of the tensors it
    writes from])``; ``kernel`` is the launch's note for a kernel op
    (``kernels/_ops.note``); ``host_sync`` says why the op syncs with the
    host, where it does."""
    name: str
    inputs: List[Meta]
    outputs: List[Meta]
    writes: List[Tuple[int, Tuple[int, ...], torch.dtype,
                       List[torch.dtype]]] = dataclasses.field(
        default_factory=list)
    new_storage: List[bool] = dataclasses.field(default_factory=list)
    in_storage: List[Optional[int]] = dataclasses.field(default_factory=list)
    kernel: Optional[Dict[str, Any]] = None
    host_sync: str = ""
    flops: int = 0
    in_bytes: int = 0
    out_bytes: int = 0
    transcendentals: int = 0


@dataclasses.dataclass
class Trace:
    """What :func:`trace` saw: the ops in order, the Python-level host
    syncs (``torch.cuda.synchronize`` and kin), the memory estimate, the
    signatures of the named tensors before and after (``carry``), the
    function's result and the seconds the trace took."""
    ops: List[OpRecord]
    syncs: List[str]
    memory: Dict[str, float]
    carry_before: Dict[str, Dict[str, Tuple]]
    carry_after: Dict[str, Dict[str, Tuple]]
    result: Any
    seconds: float


def _leaf_sigs(tree, prefix: str) -> Dict[str, Tuple]:
    from repro_torch.core.treeutil import flatten_with_path
    if isinstance(tree, torch.Tensor):
        flat = {prefix: tree}
    else:
        flat = {f"{prefix}/{k}": v
                for k, v in flatten_with_path(tree).items()}
    out = {}
    for path, t in flat.items():
        if isinstance(t, torch.Tensor):
            ref = _storage(t)
            out[path] = (tuple(t.shape), t.dtype,
                         None if ref is None else ref.cdata)
    return out


def _carry_sigs(carry: Optional[Dict[str, Callable]]) -> Dict[str, Dict]:
    return {name: _leaf_sigs(get(), name)
            for name, get in (carry or {}).items()}


def _stand_in(func, args):
    """A result for an op whose output fake mode cannot know: 0 for a
    scalar read, an empty result for ``nonzero`` and ``masked_select``;
    None where there is no sensible one."""
    name = func.__name__.split(".")[0]
    if name == "_local_scalar_dense":
        dt = args[0].dtype
        return False if dt == torch.bool else (
            0.0 if dt.is_floating_point else 0)
    if name == "nonzero":
        return torch.empty((0, args[0].dim()), dtype=torch.int64,
                           device=args[0].device)
    if name == "masked_select":
        return torch.empty((0,), dtype=args[0].dtype, device=args[0].device)
    return None


class _Recorder(TorchDispatchMode):
    """Records each op (see :class:`OpRecord`) and the live storages."""

    def __init__(self, arg_storages: Dict[int, int]):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flops = flop_registry
        self.ops: List[OpRecord] = []
        self.args = arg_storages
        self.live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.peak = 0

    def _purge(self) -> None:
        for k in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            del self.live[k]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if func is torch.ops.aten._local_scalar_dense.default:
                # DTensor reads its local scalar with no mode to see it
                t = args[0]
                self.ops.append(OpRecord(
                    str(func), [_meta(t.to_local())], [],
                    host_sync="a scalar read from the device"))
                return _stand_in(func, args)
            return NotImplemented     # DTensor issues the local ops we record
        name = str(func)
        if name.startswith("prim."):
            return func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        rec = OpRecord(name, [_meta(t) for t in ins], [])
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException, DynamicOutputShapeException)
        with _ops.recording() as notes:
            try:
                out = func(*args, **kwargs)
            except (DataDependentOutputException,
                    DynamicOutputShapeException) as e:
                rec.host_sync = (f"the result depends on the data "
                                 f"({type(e).__name__})")
                out = _stand_in(func, args)
                if out is None:
                    raise
        if notes:
            rec.kernel = notes[-1]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        rec.outputs = [_meta(t) for t in outs]
        if (func.__name__.startswith("_local_scalar_dense")
                and ins and ins[0].device.type == "cuda"):
            rec.host_sync = rec.host_sync or "a scalar read from the device"
        if (any(t.device.type == "cuda" for t in ins)
                and any(t.device.type == "cpu" for t in outs)):
            rec.host_sync = "a copy from the device to the host"
        rec.in_bytes = sum(_nbytes(t) for t in ins)
        rec.out_bytes = sum(_nbytes(t) for t in outs)
        self._writes(func, args, kwargs, rec)
        packet = func._overloadpacket
        if packet in self.flops:
            rec.flops = int(self.flops[packet](*args, **kwargs, out_val=out))
        base = func.__name__.split(".")[0]
        if base.rstrip("_") in TRANSCENDENTAL:
            rec.transcendentals = sum(t.numel() for t in outs)
        if rec.kernel and rec.kernel["kernel"].startswith("attn"):
            b, h, t, s, _ = _attn_dims(rec)
            rec.transcendentals = b * h * t * s
        self._track(ins, outs, rec)
        self.ops.append(rec)
        return out

    def _writes(self, func, args, kwargs, rec: OpRecord) -> None:
        schema = func._schema
        srcs = []
        for i, a in enumerate(schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if (isinstance(v, torch.Tensor) and v.dim() > 0
                    and not (a.alias_info and a.alias_info.is_write)
                    and not any(n in a.name for n in _INDEX_ARGS)):
                srcs.append(v.dtype)
        for i, a in enumerate(schema.arguments):
            if not (a.alias_info and a.alias_info.is_write):
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for t in tensor_leaves(v):
                ref = _storage(t)
                if ref is not None:
                    rec.writes.append((ref.cdata, tuple(t.shape), t.dtype,
                                       srcs))

    def _track(self, ins, outs, rec: OpRecord) -> None:
        self._purge()
        refs = [_storage(t) for t in ins]
        rec.in_storage = [None if r is None else r.cdata for r in refs]
        seen = {r.cdata for r in refs if r is not None}
        for t in outs:
            ref = _storage(t)
            fresh = (ref is not None and ref.cdata not in seen
                     and ref.cdata not in self.live
                     and ref.cdata not in self.args)
            rec.new_storage.append(fresh)
            if fresh:
                self.live[ref.cdata] = (ref, t.untyped_storage().nbytes())
        scratch = 0
        if rec.kernel:
            scratch = sum(torch.Size(s).numel() * dt.itemsize
                          for s, dt in rec.kernel["scratch"])
        now = sum(n for _, n in self.live.values())
        self.peak = max(self.peak, now + scratch)


def _attn_dims(rec: OpRecord):
    """(B, H, T, S, D) of an attention kernel op."""
    q, k = rec.inputs[0][0], rec.inputs[1][0]
    if rec.kernel["kernel"] == "attn_decode":
        b, kv, g, d = q
        return b, kv * g, 1, k[1], d
    b, t, kv, g, d = q
    return b, kv * g, t, k[1], d


@contextlib.contextmanager
def _sync_watch(syncs: List[str]):
    """Record every ``torch.cuda.synchronize``, ``Stream.synchronize`` and
    ``Event.synchronize`` called inside (and do not call them)."""
    targets = [(torch.cuda, "synchronize"),
               (torch.cuda.Stream, "synchronize"),
               (torch.cuda.Event, "synchronize")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr in targets]

    def watcher(label):
        def f(*a, **k):
            syncs.append(label)
        return f

    for obj, attr, _ in saved:
        setattr(obj, attr, watcher(f"{getattr(obj, '__name__', obj)}."
                                   f"{attr}"))
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


class _CudaMethods(TorchFunctionMode):
    """The tensor methods whose Python binding takes a CUDA device guard
    before it dispatches — ``t[idx]``, ``t[idx] = v``, ``~t``, ``copy_``,
    ``nonzero``, ``uniform_`` — on fake CUDA tensors, through the
    dispatcher's ops (``select``, ``slice``, ``unsqueeze``, ``index``,
    ``index_put_``, ``copy_``, ``bitwise_not``, …). A build of torch
    without CUDA has no CUDA device guard, so there a fake ``"cuda"``
    tensor takes them no other way. A boolean mask index becomes
    ``nonzero`` (a host sync, as on the card)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if (func in _GUARDED and args and isinstance(args[0], torch.Tensor)
                and not isinstance(args[0], DTensor)
                and args[0].device.type == "cuda"):
            with torch._C.DisableTorchFunction():
                if func is torch.Tensor.__getitem__:
                    return _getitem(args[0], args[1])
                if func is torch.Tensor.__setitem__:
                    _setitem(args[0], args[1], args[2])
                    return None
                return _GUARDED[func](*args, **kwargs)
        return func(*args, **kwargs)


_aten = torch.ops.aten
_GUARDED = {torch.Tensor.__getitem__: None, torch.Tensor.__setitem__: None,
            torch.Tensor.__invert__: _aten.bitwise_not,
            torch.Tensor.copy_: _aten.copy_,
            torch.Tensor.nonzero: _aten.nonzero, torch.nonzero: _aten.nonzero,
            torch.Tensor.uniform_: _aten.uniform_}


def _index_parts(t: torch.Tensor, idx):
    """The basic view of ``t[idx]`` (selects, slices, new axes) and the
    advanced indices on its dims (a list of index tensors or None, or None
    when there are none)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = tuple(torch.tensor(i, device=t.device) if isinstance(i, list)
                else i for i in idx)

    def width(i):
        if i is None or i is Ellipsis:
            return 0
        if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            return max(i.dim(), 1)
        return 1

    if any(i is Ellipsis for i in idx):
        at = next(k for k, i in enumerate(idx) if i is Ellipsis)
        fill = t.dim() - sum(width(i) for i in idx)
        idx = idx[:at] + (slice(None),) * fill + idx[at + 1:]
    r, d, adv = t, 0, {}
    for i in idx:
        if i is None:
            r = torch.ops.aten.unsqueeze.default(r, d)
            d += 1
        elif isinstance(i, bool):
            raise NotImplementedError("indexing with a Python bool")
        elif isinstance(i, int):
            r = torch.ops.aten.select.int(r, d, i)
        elif isinstance(i, slice):
            step = 1 if i.step is None else i.step
            r = torch.ops.aten.slice.Tensor(r, d, i.start, i.stop, step)
            d += 1
        elif isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            for k, ix in enumerate(torch.ops.aten.nonzero.default(i)
                                   .unbind(1)):
                adv[d + k] = ix
            d += max(i.dim(), 1)
        elif isinstance(i, torch.Tensor):
            adv[d] = i.to(torch.int64) if i.dtype == torch.int32 else i
            d += 1
        else:
            raise NotImplementedError(f"indexing with {type(i).__name__}")
    if not adv:
        return r, None
    return r, [adv.get(k) for k in range(max(adv) + 1)]


def _getitem(t: torch.Tensor, idx):
    r, adv = _index_parts(t, idx)
    return r if adv is None else torch.ops.aten.index.Tensor(r, adv)


def _setitem(t: torch.Tensor, idx, value) -> None:
    r, adv = _index_parts(t, idx)
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=r.dtype, device=r.device)
    if adv is None:
        torch.ops.aten.copy_.default(r, value)
    else:
        torch.ops.aten.index_put_.default(r, adv, value.to(r.dtype))


class FakeMode:
    """``FakeTensorMode`` (real tensors an op meets become fake) and, on a
    build without CUDA, the few methods of fake CUDA tensors that need a
    CUDA device guard, through the dispatcher (:class:`_CudaMethods`). ``from_tensor`` makes a fake
    tensor of this mode."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensorMode
        self.mode = FakeTensorMode(allow_non_fake_inputs=True)
        self._stacks: List[contextlib.ExitStack] = []

    def from_tensor(self, t: torch.Tensor) -> torch.Tensor:
        return self.mode.from_tensor(t)

    def __enter__(self):
        stack = contextlib.ExitStack()
        stack.enter_context(self.mode)
        if not torch.cuda.is_available():
            stack.enter_context(_CudaMethods())
        self._stacks.append(stack)
        return self

    def __exit__(self, *exc):
        return self._stacks.pop().__exit__(*exc)


def fake_mode() -> FakeMode:
    """A new :class:`FakeMode`."""
    return FakeMode()


def fake_tree(tree, mode, device=None):
    """A nest of dicts, lists and tuples with every real tensor replaced by
    a fake one of ``mode`` (on ``device`` where given; a CUDA device with
    its index, ``cuda:0``, on a build without CUDA): the stand-in for the
    reference's ``ShapeDtypeStruct`` trees."""
    if isinstance(tree, torch.Tensor):
        t = mode.from_tensor(tree)
        if device is not None:
            with mode:
                t = t.to(device)
        return t
    if isinstance(tree, dict):
        return {k: fake_tree(v, mode, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_tree(v, mode, device) for v in tree)
    return tree


def trace(fn: Callable, *args, inputs: Any = None,
          carry: Optional[Dict[str, Callable]] = None,
          mode=None) -> Trace:
    """Run ``fn(*args)`` under fake tensors and record it.

    ``inputs`` names tensors the function reads besides ``args`` (an
    engine's state: they count as arguments in the memory estimate);
    ``carry`` maps names to getters of tensors (or trees of them) whose
    shape, dtype and storage are read before and after. ``mode`` is the
    :class:`FakeMode` to run under, by default a new one; args made under
    another fake mode need theirs."""
    mode = mode or fake_mode()
    arg_storages: Dict[int, int] = {}
    for t in tensor_leaves(list(args)) + tensor_leaves(inputs):
        if isinstance(t, torch.Tensor):
            from torch.distributed.tensor import DTensor
            if isinstance(t, DTensor):
                t = t.to_local()
            ref = _storage(t)
            if ref is not None:
                arg_storages[ref.cdata] = t.untyped_storage().nbytes()
    rec = _Recorder(arg_storages)
    syncs: List[str] = []
    t0 = time.perf_counter()
    with mode, torch.no_grad():
        before = _carry_sigs(carry)
        with _sync_watch(syncs), rec:
            result = fn(*args)
        after = _carry_sigs(carry)
    seconds = time.perf_counter() - t0
    memory = _memory(rec, result)
    return Trace(rec.ops, syncs, memory, before, after, result, seconds)


def _memory(rec: _Recorder, result) -> Dict[str, float]:
    from torch.distributed.tensor import DTensor
    arg = float(sum(rec.args.values()))
    out_b = new_out = alias = 0.0
    seen = set()
    for t in tensor_leaves(result):
        if isinstance(t, DTensor):
            t = t.to_local()
        ref = _storage(t)
        if ref is None or ref.cdata in seen:
            continue
        seen.add(ref.cdata)
        n = t.untyped_storage().nbytes()
        out_b += n
        if ref.cdata in rec.args:
            alias += n
        else:
            new_out += n
    temp = max(0.0, rec.peak - new_out)
    return {"argument_bytes": arg, "output_bytes": out_b,
            "temp_bytes": temp, "alias_bytes": alias,
            "peak_bytes_est": arg + temp + out_b - alias}


# --- walkers ----------------------------------------------------------------------

def is_kernel(rec: OpRecord) -> bool:
    return rec.name.startswith(KERNEL_NS)


def iter_ops(tr: Trace) -> Iterator[OpRecord]:
    """Every op of the trace, in order (a kernel op is one op: its tiles
    are not in the trace)."""
    return iter(tr.ops)


def _meta_str(m: Meta) -> str:
    return f"{str(m[1]).replace('torch.', '')}{list(m[0])}"


def op_label(rec: OpRecord) -> str:
    """Short label naming an op: name[variant] -> result shapes."""
    name = rec.name
    if rec.kernel and rec.kernel.get("variant"):
        name = f"{name}[{rec.kernel['variant']}]"
    outs = ", ".join(_meta_str(m) for m in rec.outputs)
    return f"{name} -> {outs}" if outs else name


def float_shapes_outside_kernels(tr: Trace) -> Tuple[Dict[tuple, str], bool]:
    """All float-dtype result shapes of the trace outside kernel ops, each
    with the label of the first op producing it, and whether a kernel op
    ran at all."""
    shapes: Dict[tuple, str] = {}
    saw = False
    for rec in iter_ops(tr):
        if is_kernel(rec):
            saw = True
            continue
        for shape, dtype, _ in rec.outputs:
            if dtype.is_floating_point:
                shapes.setdefault(tuple(shape), op_label(rec))
    return shapes, saw


def find_kernel_ops(tr: Trace) -> List[OpRecord]:
    """Every kernel op of the trace, in order."""
    return [r for r in iter_ops(tr) if is_kernel(r)]
