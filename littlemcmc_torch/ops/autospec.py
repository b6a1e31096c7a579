"""Auto-lowering of a traced torch model into the CUDA kernels' model body.

Counterpart of ``littlemcmc_tpu/ops/autospec.py``: ``make_trajectory_spec``
(``make_pallas_model_spec``, ``:411``), ``probe_spec`` (``:504``, its
``pallas_call`` at ``:540``) and ``try_auto_spec`` (``:586``, with the
per-callable cache of ``_cached_auto_spec``, ``:572``). A user hands
``sample()`` a log density; where the model has no hand-written body, this
module turns it into one that the four transition kernels inline
(``model_eval<kAutoBody>`` of ``csrc/nuts_transition.cuh``):

1. **Trace.** The per-chain ``(logp, grad)`` (a ``logp_fn`` through
   :func:`~littlemcmc_torch.model.from_logp_fn`) is traced at shape
   ``(ndim,)`` with ``make_fx`` on fake tensors, functionalized. Closure
   tensors surface as graph constants. Python control flow on the values
   of ``q``, a host (numpy) callable, an op outside the set below, a
   float64 value, a value of rank above 2 or a model wider than
   ``MAX_NDIM`` declines here, before any ``nvcc``:
   :func:`try_auto_spec` returns None with an info log line and
   ``sample()`` runs the tensor-op tree. This :class:`Decline` is the
   only way onto the tree: any other exception of the lowering, the
   emitter or the build propagates.
2. **Lower.** The graph becomes a straight-line program over values of
   rank <= 2 (:class:`Program`): elementwise ops, full reductions,
   reductions over an axis, ``mv``/``mm``/``dot``, gathers and scatter-adds.
   Every op whose output is a selection of its input's elements (views,
   slices, ``select``, ``t``, ``expand``, ``cat``, ``index_select`` and
   ``x[idx]`` by a constant index, ``select_backward``/``slice_backward``)
   becomes one gather through a constant index map, found by applying the
   op to ``arange``; every scatter-add (``index_add``, ``index_put`` with
   ``accumulate=True``, the reductions over an axis) one segment sum
   through a constant CSR map, its terms added in the index order, as
   PyTorch's CPU kernels add them. Ops on constants alone are evaluated
   here. Values of one element live in registers.
3. **Fuse.** Consecutive ops that compute their output element by element
   over one shape (elementwise ops, gathers, segment sums, ``mv``/``mm``),
   with the full reductions of values of that shape, become one loop
   (:class:`Step`); each element's values are registers of the loop. A
   value takes a slot of the per-chain scratch only where it is read at
   another element (a gather's source, a matmul's operands, a segment
   sum's terms, a broadcast) or after its loop; slots are reused by
   liveness, a loop counting as one op.
4. **Emit.** The program becomes one CUDA device function,
   ``autobody::eval(q, g, lam, n, lane, scratch)``, with ``model_eval``'s
   contract: one warp a chain, ``q`` and ``g`` in shared memory, ``logp``
   returned; each loop a ``for (i = lane; i < len; i += 32)`` loop and a
   ``__syncwarp()``, each full reduction a lane's sum in the loop and a
   warp sum after it. The constants are the body's packed buffer (index
   maps as int32 bits), which the kernels stage in shared memory where the
   launch has room; the scratch rows ``(warps, scratch_floats)`` follow
   them there where they fit, else they are a global buffer bound to the
   library (:func:`scratch_in_smem` reads the last launch's placement).
5. **Build.** ``ops/_build.py::build_generated`` writes the header and a
   translation unit that includes the kernel's ``.cu`` with the generated
   body switched on, and compiles it with the kernels' flags into
   ``build/littlemcmc_torch/autospec/<hash>/``, at the first launch of the
   kernel the elected engine runs. A failed ``nvcc`` or launch raises.
6. **Probe.** :func:`probe_spec` builds ``csrc/autospec_probe.cu`` with the
   generated bodies, evaluates each alone on 8 chains at three input
   scales (0.1, 1 and 5, as the JAX probe) and holds it against the plain
   version at the JAX probe's tolerance (rtol 5e-3, atol 1e-3). Every
   generated body is probed once before its first kernel launch.

**Departure from the JAX package:** a probe that disagrees **raises**
(with the model's name), where the JAX probe returns False and ``sample()``
falls back. A generated body that computes another function is a fault of
this module, not a property of the user's model, and falling back would
hide it. Only a trace-time decline leads to the tree.

The plain version of a generated body is the traced graph itself, mapped
over chains with ``torch.func.vmap`` (:meth:`Program.plain`), so the
kernels' plain versions run generated specs unchanged on the CPU.
:func:`interpret` runs the fused program in numpy, loop by loop, its
registers, slots and maps included, which holds the lowering on a machine
without ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import math
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..model import from_logp_fn
from .nuts_trajectory import TrajectorySpec

__all__ = ["Decline", "Program", "Step", "make_trajectory_spec", "probe_spec", "probe_specs",
           "run_probe", "try_auto_spec", "interpret", "header_source", "probe_header",
           "scratch_in_smem", "MAX_NDIM"]

_log = logging.getLogger("littlemcmc_torch")

# the kernels' register tile (kMaxCols x 32, csrc/nuts_transition.cuh): the
# fused kernels take n <= 256, and so do the generated bodies
MAX_NDIM = 256
# floats of one chain's scratch (a 1024-chain launch holds 128 MB of it)
MAX_SCRATCH_FLOATS = 1 << 15
PROBE_CHAINS = 8
PROBE_SCALES = (0.1, 1.0, 5.0)
PROBE_RTOL, PROBE_ATOL = 5e-3, 1e-3


class Decline(Exception):
    """The model does not lower into a kernel body; the message says why."""


# --------------------------------------------------------------------------
# The program
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Value:
    """One value of the program: its shape, where it lives (``q``, a
    constant at ``off`` in the packed buffer, a register, a literal, a
    scratch buffer ``buf`` whose offset the allocator sets, or ``local``:
    a buffer read only element by element inside the loop that computes
    it, which lives in that loop's registers) and its type (``f`` float32,
    ``b`` a flag held as 0/1, ``i`` an int32 index)."""

    shape: Tuple[int, ...]
    kind: str
    dtype: str = "f"
    lit: float = 0.0
    buf: int = -1
    off: int = 0
    data: Optional[torch.Tensor] = None  # a constant's value

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass
class Instr:
    """One op: ``ew`` (``fn`` over ``ins``, broadcast to ``out``'s shape),
    ``reduce`` (``fn`` ``sum`` or ``max`` of ``ins[0]`` into a register),
    ``segment`` (out[o] = ins[0][o] + the ``ins[1]`` terms of segment
    ``o``: ``maps = (starts, members)``; ``fn`` ``sum`` or ``max``),
    ``gather`` (out[i] = the source whose map holds an index >= 0 at i,
    read there, else 0: ``maps`` one per source in ``ins``), ``mv``,
    ``mm`` and ``dot``."""

    op: str
    out: int
    ins: Tuple[int, ...]
    fn: str = ""
    maps: Tuple[int, ...] = ()
    params: Tuple = ()


# elementwise functions: arity, CUDA expression over {0}, {1}, ...
# (parameters as {p0}, {p1}), numpy function over float32 arrays (and the
# parameters). Each follows the formula of PyTorch's CPU kernel, so that
# the kernel, the plain version and the interpreter round alike.
def _np_softplus(x, beta, th):
    with np.errstate(over="ignore"):
        return np.where(x * beta > th, x, np.log1p(np.exp(x * beta)) / beta)


def _np_softplus_bw(g, x, beta, th):
    with np.errstate(over="ignore", invalid="ignore"):
        z = np.exp(x * beta)
        return np.where(x * beta > th, g, g * z / (z + np.float32(1)))


def _np_log_sigmoid_bw(g, x):
    neg = x < 0
    z = np.exp(-np.abs(x))
    return g * (np.where(neg, 1, 0).astype(np.float32)
                - np.where(neg, 1, -1).astype(np.float32) * (z / (np.float32(1) + z)))


def _np_logaddexp(a, b):
    with np.errstate(invalid="ignore"):
        m = np.maximum(a, b)
        out = m + np.log1p(np.exp(-np.abs(a - b)))
        return np.where(np.isinf(a) & (a == b), a, out)


def _f(x):
    return np.asarray(x, np.float32)


_EW = {
    "add": (2, "({0} + {1})", np.add),
    "sub": (2, "({0} - {1})", np.subtract),
    "mul": (2, "({0} * {1})", np.multiply),
    "div": (2, "({0} / {1})", np.divide),
    "neg": (1, "(-{0})", np.negative),
    "exp": (1, "expf({0})", np.exp),
    "log": (1, "logf({0})", np.log),
    "log1p": (1, "log1pf({0})", np.log1p),
    "expm1": (1, "expm1f({0})", np.expm1),
    "tanh": (1, "tanhf({0})", np.tanh),
    "sqrt": (1, "sqrtf({0})", np.sqrt),
    "rsqrt": (1, "(1.0f / sqrtf({0}))", lambda x: _f(1) / np.sqrt(x)),
    "reciprocal": (1, "(1.0f / {0})", lambda x: _f(1) / x),
    "abs": (1, "fabsf({0})", np.abs),
    "sin": (1, "sinf({0})", np.sin),
    "cos": (1, "cosf({0})", np.cos),
    "sigmoid": (1, "(1.0f / (1.0f + expf(-{0})))",
                lambda x: _f(1) / (_f(1) + np.exp(-x))),
    "sign": (1, "(float)(({0} > 0.0f) - ({0} < 0.0f))", lambda x: _f(np.sign(x))),
    "relu": (1, "({0} > 0.0f ? {0} : 0.0f)", lambda x: np.where(x > 0, x, _f(0))),
    "powf": (2, "powf({0}, {1})", np.power),
    "maximum": (2, "fmaxf({0}, {1})", np.maximum),
    "minimum": (2, "fminf({0}, {1})", np.minimum),
    "clamp_min": (2, "fmaxf({0}, {1})", np.maximum),
    "clamp_max": (2, "fminf({0}, {1})", np.minimum),
    "where": (3, "({0} != 0.0f ? {1} : {2})", lambda c, a, b: np.where(c != 0, a, b)),
    "lt": (2, "(float)({0} < {1})", lambda a, b: _f(a < b)),
    "le": (2, "(float)({0} <= {1})", lambda a, b: _f(a <= b)),
    "gt": (2, "(float)({0} > {1})", lambda a, b: _f(a > b)),
    "ge": (2, "(float)({0} >= {1})", lambda a, b: _f(a >= b)),
    "eq": (2, "(float)({0} == {1})", lambda a, b: _f(a == b)),
    "ne": (2, "(float)({0} != {1})", lambda a, b: _f(a != b)),
    "logical_and": (2, "(float)(({0} != 0.0f) && ({1} != 0.0f))",
                    lambda a, b: _f((a != 0) & (b != 0))),
    "logical_or": (2, "(float)(({0} != 0.0f) || ({1} != 0.0f))",
                   lambda a, b: _f((a != 0) | (b != 0))),
    "logical_not": (1, "(float)({0} == 0.0f)", lambda a: _f(a == 0)),
    "softplus": (1, "({0} * {p0} > {p1} ? {0} : log1pf(expf({0} * {p0})) / {p0})",
                 _np_softplus),
    "softplus_backward": (2, "({1} * {p0} > {p1} ? {0} : {0} * expf({1} * {p0}) "
                             "/ (expf({1} * {p0}) + 1.0f))", _np_softplus_bw),
    "log_sigmoid": (1, "(fminf({0}, 0.0f) - log1pf(expf(-fabsf({0}))))",
                    lambda x: np.minimum(x, _f(0)) - np.log1p(np.exp(-np.abs(x)))),
    "log_sigmoid_backward": (2, "ax_log_sigmoid_bw({0}, {1})", _np_log_sigmoid_bw),
    "sigmoid_backward": (2, "(({0} * (1.0f - {1})) * {1})",
                         lambda g, y: (g * (_f(1) - y)) * y),
    "tanh_backward": (2, "({0} * (1.0f - {1} * {1}))", lambda g, y: g * (_f(1) - y * y)),
    "threshold_backward": (2, "({1} <= {p0} ? 0.0f : {0})",
                           lambda g, x, th: np.where(x <= th, _f(0), g)),
    "logaddexp": (2, "ax_logaddexp({0}, {1})", _np_logaddexp),
}

# aten name (the overload packet's, "_copy" stripped) -> elementwise function
_ATEN_EW = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div", "true_divide": "div",
    "neg": "neg", "exp": "exp", "log": "log", "log1p": "log1p", "expm1": "expm1",
    "tanh": "tanh", "sqrt": "sqrt", "rsqrt": "rsqrt", "reciprocal": "reciprocal",
    "abs": "abs", "sin": "sin", "cos": "cos", "sigmoid": "sigmoid", "sign": "sign",
    "sgn": "sign", "relu": "relu", "maximum": "maximum", "minimum": "minimum",
    "clamp_min": "clamp_min", "clamp_max": "clamp_max", "where": "where",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "logical_and": "logical_and", "logical_or": "logical_or", "logical_not": "logical_not",
    "sigmoid_backward": "sigmoid_backward", "tanh_backward": "tanh_backward",
    "log_sigmoid_backward": "log_sigmoid_backward", "logaddexp": "logaddexp",
}

# ops whose output is a selection of one input's elements (zeros
# elsewhere), and the inputs that must be constant indices
# a matrix-vector product with at most this many outputs, each a sum of
# at least 32 terms, splits each sum across the warp's lanes (a "rows"
# step) instead of giving each output to one lane
THIN_MV_OUTPUTS = 8


@dataclasses.dataclass
class Step:
    """One step of the emitted body: one op with a one-element output
    (``shape`` None), one thin matrix-vector product whose sums the lanes
    split (``rows``), or one loop over the elements of ``shape`` running
    ``instrs`` in order, each element's values in registers; its
    reductions add per lane in the loop and across the warp after it.
    ``g_store``: the loop writes the gradient's elements into ``g``."""

    shape: Optional[Tuple[int, ...]]
    instrs: List[Instr]
    g_store: bool = False
    rows: bool = False


_MOVES = {"view", "_unsafe_view", "reshape", "alias", "detach", "clone", "lift_fresh_copy",
          "unsqueeze", "squeeze", "expand", "t", "transpose", "permute", "select", "slice",
          "narrow", "index_select", "index", "select_backward", "slice_backward", "flip",
          "roll", "repeat", "diagonal"}
_CREATORS = {"ones_like", "zeros_like", "full_like", "new_zeros", "new_ones", "new_full",
             "zeros", "ones", "full", "scalar_tensor", "empty_like", "new_empty"}


@dataclasses.dataclass(eq=False)
class Program:
    """A lowered model: its values and ops, the steps (loops) the ops are
    fused into, the packed constants and the scratch it needs, the emitted
    body and its hash, the operations of one evaluation (for the bound)
    and the traced graph (the plain version)."""

    name: str
    ndim: int
    values: List[Value]
    instrs: List[Instr]
    logp: int
    grad: int
    const_parts: List[torch.Tensor]
    const_floats: int
    scratch_floats: int
    flops: int
    graph: torch.fx.GraphModule
    steps: List[Step] = dataclasses.field(default_factory=list)
    body: str = ""
    digest: str = ""
    probed: bool = False
    # kernel name -> (library, path) of its build with this body, loaded once
    libraries: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def plain(self, q: torch.Tensor):
        """``(logp (C,), grad (C, n))`` at ``q (C, n)``: the traced graph,
        vmapped over chains (its constants on the device it was traced on)."""
        return torch.func.vmap(self.graph)(q)


# --------------------------------------------------------------------------
# Trace and lower
# --------------------------------------------------------------------------

def _trace(fn: Callable, ndim: int, device) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        return make_fx(torch.func.functionalize(fn, remove="mutations"), tracing_mode="fake",
                       _allow_non_fake_inputs=True)(
            torch.zeros(ndim, dtype=torch.float32, device=device))
    except Exception as e:  # data-dependent control flow, host callbacks, ...
        raise Decline(f"the model does not trace ({type(e).__name__}: "
                      f"{str(e).splitlines()[0][:160] if str(e) else ''})") from e


def _dtype_code(dt) -> str:
    if dt == torch.float32:
        return "f"
    if dt == torch.bool:
        return "b"
    if dt in (torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8):
        return "i"
    raise Decline(f"a value of dtype {dt} (the kernels run float32)")


class _Lowering:
    """Walks the traced graph once, building the program's values and ops."""

    def __init__(self, gm: torch.fx.GraphModule, ndim: int):
        self.gm = gm
        self.ndim = ndim
        self.values: List[Value] = []
        self.instrs: List[Instr] = []
        self.env: Dict[torch.fx.Node, object] = {}
        self.n_bufs = 0

    # values ----------------------------------------------------------------
    def add(self, v: Value) -> int:
        self.values.append(v)
        return len(self.values) - 1

    def lit(self, x, shape=(), dtype="f") -> int:
        return self.add(Value(tuple(shape), "lit", dtype, lit=float(np.float32(x))))

    def const(self, t: torch.Tensor) -> int:
        t = t.detach().cpu()  # folded and mapped on the host; packed onto the device
        dt = _dtype_code(t.dtype)
        if t.numel() == 1 or (t.numel() > 1 and bool((t == t.reshape(-1)[0]).all())):
            return self.lit(t.reshape(-1)[0].item(), t.shape, dt)
        if t.dim() > 2:
            raise Decline(f"a constant of rank {t.dim()} (the kernels take rank <= 2)")
        return self.add(Value(tuple(t.shape), "const", dt, data=t))

    def out(self, shape, dtype="f") -> int:
        shape = tuple(int(s) for s in shape)
        if len(shape) > 2:
            raise Decline(f"a value of rank {len(shape)} (the kernels take rank <= 2)")
        self.n_bufs += 1
        kind = "reg" if math.prod(shape) == 1 else "slot"
        return self.add(Value(shape, kind, dtype, buf=self.n_bufs - 1))

    def alias(self, vid: int, shape, dtype=None) -> int:
        v = self.values[vid]
        return self.add(dataclasses.replace(v, shape=tuple(int(s) for s in shape),
                                            dtype=dtype or v.dtype))

    def index_map(self, idx: torch.Tensor) -> int:
        """An int32 constant (index maps, CSR starts)."""
        return self.add(Value(tuple(idx.shape), "const", "i", data=idx.to(torch.int32)))

    def is_const(self, vid: int) -> bool:
        return self.values[vid].kind in ("const", "lit")

    def real(self, vid: int) -> torch.Tensor:
        """A constant's value as a tensor."""
        v = self.values[vid]
        if v.kind == "const":
            return v.data
        dt = {"f": torch.float32, "b": torch.bool, "i": torch.int64}[v.dtype]
        return torch.full(v.shape, v.lit, dtype=torch.float32).to(dt)

    # the walk --------------------------------------------------------------
    def run(self):
        outputs = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.env[node] = self.add(Value((self.ndim,), "q"))
            elif node.op == "get_attr":
                self.env[node] = self.const(getattr(self.gm, node.target))
            elif node.op == "call_function":
                self.env[node] = self.call(node)
            elif node.op == "output":
                outputs = node.args[0]
            else:
                raise Decline(f"graph node {node.op}")
        outs = [self.env[o] for o in outputs]
        if len(outs) != 2:
            raise ValueError("the model must map (ndim,) -> (scalar logp, (ndim,) grad)")
        lp, g = outs
        if self.values[lp].shape != () or self.values[g].shape != (self.ndim,):
            raise ValueError("the model must map (ndim,) -> (scalar logp, (ndim,) grad); "
                             f"traced output shapes were {[self.values[lp].shape, self.values[g].shape]}")
        return lp, g

    def call(self, node):
        target = node.target
        if target is operator.getitem:
            return self.env[node.args[0]][node.args[1]]
        if not isinstance(target, torch._ops.OpOverload):
            raise Decline(f"the call {target}")
        name = target._overloadpacket.__name__
        if name.endswith("_copy") and name not in ("lift_fresh_copy", "_to_copy"):
            name = name[:-5]
        val = node.meta.get("val")
        if name == "log_sigmoid_forward":
            out = self.elementwise("log_sigmoid", [self.env[node.args[0]]], val[0].shape)
            return (out, self.lit(0.0, val[1].shape))
        if isinstance(val, (list, tuple)):
            raise Decline(f"the op aten.{name} with {len(val)} outputs")
        if val is not None and not isinstance(val, torch.Tensor):
            raise Decline(f"the op aten.{name} returns {type(val).__name__}")
        dt = _dtype_code(val.dtype)
        if name in _CREATORS:
            fill = {"ones_like": 1.0, "new_ones": 1.0, "ones": 1.0}.get(name, 0.0)
            if name in ("full_like", "new_full"):
                fill = node.args[1] if name == "full_like" else node.args[2]
            elif name == "full":
                fill = node.args[1]
            elif name == "scalar_tensor":
                fill = node.args[0]
            return self.lit(float(fill), val.shape, dt)
        inputs = [self.env[a] for a in node.all_input_nodes]
        if all(isinstance(x, int) and self.is_const(x) for x in inputs):
            return self.fold(node, target)
        if name == "_to_copy":
            if dt == "i":
                raise Decline("a cast of a computed value to an integer type")
            return self.alias(self.env[node.args[0]], val.shape, dt)
        if name in _MOVES:
            return self.move(name, node, target, val)
        if name == "cat":
            return self.cat(node, val)
        return self.compute(name, node, val)

    def fold(self, node, target):
        """An op on constants alone, evaluated here."""
        def real(a):
            if isinstance(a, torch.fx.Node):
                got = self.env[a]
                if isinstance(got, tuple):
                    return tuple(self.real(x) for x in got)
                return self.real(got)
            if isinstance(a, (list, tuple)):
                return type(a)(real(x) for x in a)
            return a

        res = target(*real(node.args), **{k: real(v) for k, v in node.kwargs.items()})
        if isinstance(res, (list, tuple)):
            return tuple(self.const(r) for r in res)
        return self.const(res)

    def move(self, name, node, target, val):
        """A selection of one input's elements: an alias where the order
        is unchanged, else a gather through the map of the op applied to
        ``arange``."""
        src = self.env[node.args[0]]
        sv = self.values[src]
        dt = _dtype_code(val.dtype)
        if sv.numel == 1 and sv.kind in ("reg", "lit") and name in (
                "expand", "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "alias",
                "clone", "detach", "t", "permute", "transpose"):
            return self.alias(src, val.shape, dt)

        def real(a, first):
            if isinstance(a, torch.fx.Node):
                if first:
                    return torch.arange(1, sv.numel + 1, dtype=torch.float64).reshape(sv.shape)
                vid = self.env[a]
                if not self.is_const(vid):
                    raise Decline("an index that depends on the position")
                return self.real(vid)
            if isinstance(a, (list, tuple)):
                return type(a)(real(x, False) for x in a)
            return a

        idx_args = [real(a, i == 0) for i, a in enumerate(node.args)]
        kw = {k: real(v, False) for k, v in node.kwargs.items()}
        for k in ("dtype", "device", "layout", "pin_memory"):
            kw.pop(k, None)
        mapped = target(*idx_args, **kw)
        flat = (mapped.reshape(-1).round().to(torch.int64) - 1)
        shape = tuple(val.shape)
        if tuple(mapped.shape) != shape:
            raise Decline(f"aten.{node.target} changed shape under its index map")
        if flat.numel() == sv.numel and torch.equal(flat, torch.arange(sv.numel)):
            return self.alias(src, shape, dt)
        out = self.out(shape, dt)
        self.instrs.append(Instr("gather", out, (src,), maps=(self.index_map(flat),)))
        return out

    def cat(self, node, val):
        tensors = [self.env[a] for a in node.args[0]]
        dim = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", 0)
        parts, total = [], 0
        for vid in tensors:
            n = self.values[vid].numel
            parts.append(torch.arange(total + 1, total + n + 1, dtype=torch.float64)
                         .reshape(self.values[vid].shape))
            total += n
        whole = torch.cat(parts, dim).reshape(-1).to(torch.int64) - 1
        maps, start = [], 0
        for vid in tensors:
            n = self.values[vid].numel
            m = torch.where((whole >= start) & (whole < start + n), whole - start,
                            torch.full_like(whole, -1))
            maps.append(self.index_map(m))
            start += n
        out = self.out(val.shape, _dtype_code(val.dtype))
        self.instrs.append(Instr("gather", out, tuple(tensors), maps=tuple(maps)))
        return out

    def elementwise(self, fn, ins, shape, dtype="f", params=()):
        out = self.out(shape, dtype)
        self.instrs.append(Instr("ew", out, tuple(ins), fn=fn, params=tuple(params)))
        return out

    def scaled(self, vid, factor) -> int:
        """``vid`` times a number (the value itself for 1)."""
        if factor == 1:
            return vid
        return self.elementwise("mul", [vid, self.lit(factor)], self.values[vid].shape)

    def scalar(self, x) -> int:
        """A node argument's value id: a traced value, or a number as a
        literal."""
        if isinstance(x, torch.fx.Node):
            return self.env[x]
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            raise Decline(f"the argument {x!r}")
        return self.lit(x)

    def compute(self, name, node, val):
        raw = node.args

        def v(i):
            return self.scalar(raw[i])

        shape, dt = val.shape, _dtype_code(val.dtype)
        if name in ("add", "sub"):
            alpha = node.kwargs.get("alpha", raw[2] if len(raw) > 2 else 1)
            return self.elementwise(name, [v(0), self.scaled(v(1), alpha)], shape)
        if name == "rsub":
            alpha = node.kwargs.get("alpha", raw[2] if len(raw) > 2 else 1)
            return self.elementwise("sub", [v(1), self.scaled(v(0), alpha)], shape)
        if name in _ATEN_EW:
            fn = _ATEN_EW[name]
            if name == "div" and node.kwargs.get("rounding_mode") is not None:
                raise Decline("a division with a rounding mode")
            return self.elementwise(fn, [v(i) for i in range(_EW[fn][0])], shape, dt)
        if name == "pow":
            ex = raw[1]
            if isinstance(ex, (int, float)) and not isinstance(ex, bool):
                return self.power(v(0), float(ex), shape)
            return self.elementwise("powf", [v(0), v(1)], shape)
        if name == "square":
            return self.power(v(0), 2.0, shape)
        if name == "clamp":
            lo = raw[1] if len(raw) > 1 else node.kwargs.get("min")
            hi = raw[2] if len(raw) > 2 else node.kwargs.get("max")
            x = v(0)
            if lo is not None:
                x = self.elementwise("clamp_min", [x, self.scalar(lo)], shape)
            if hi is not None:
                x = self.elementwise("clamp_max", [x, self.scalar(hi)], shape)
            return x
        if name == "masked_fill":
            return self.elementwise("where", [v(1), self.scalar(raw[2]), v(0)], shape, dt)
        if name == "softplus":
            beta = raw[1] if len(raw) > 1 else 1.0
            th = raw[2] if len(raw) > 2 else 20.0
            return self.elementwise("softplus", [v(0)], shape, params=(float(beta), float(th)))
        if name == "softplus_backward":
            return self.elementwise("softplus_backward", [v(0), v(1)], shape,
                                    params=(float(raw[2]), float(raw[3])))
        if name == "threshold_backward":
            return self.elementwise("threshold_backward", [v(0), v(1)], shape,
                                    params=(float(raw[2]),))
        if name in ("sum", "mean", "amax", "amin", "max", "min"):
            return self.reduction(name, node, v(0), val)
        if name in ("mv", "mm", "dot"):
            return self.matmul(name, v(0), v(1), val)
        if name in ("addmv", "addmm"):
            beta = node.kwargs.get("beta", 1)
            alpha = node.kwargs.get("alpha", 1)
            prod = self.scaled(self.matmul(name[3:], v(1), v(2), val), alpha)
            return self.elementwise("add", [self.scaled(v(0), beta), prod], shape)
        if name in ("index_put", "index_add"):
            return self.scatter_add(name, node, val)
        raise Decline(f"the op aten.{name}")

    def power(self, x, p, shape):
        if p == 1.0:
            return self.alias(x, shape)
        if p == 2.0:
            return self.elementwise("mul", [x, x], shape)
        if p == 0.5:
            return self.elementwise("sqrt", [x], shape)
        if p == -1.0:
            return self.elementwise("reciprocal", [x], shape)
        return self.elementwise("powf", [x, self.lit(p)], shape)

    def reduction(self, name, node, x, val):
        xv = self.values[x]
        raw = node.args
        dims = raw[1] if len(raw) > 1 else node.kwargs.get("dim")
        fn = "sum" if name in ("sum", "mean") else "max" if name in ("amax", "max") else "min"
        if name in ("max", "min") and dims is not None:
            raise Decline(f"aten.{name} over a dimension (it returns indices)")
        if isinstance(dims, int):
            dims = [dims]
        if not dims or sorted(d % max(len(xv.shape), 1) for d in dims) == list(
                range(len(xv.shape))):
            out = self.out(val.shape, "f")
            if fn == "min":
                neg = self.elementwise("neg", [x], xv.shape)
                m = self.out(val.shape, "f")
                self.instrs.append(Instr("reduce", m, (neg,), fn="max"))
                self.instrs.append(Instr("ew", out, (m,), fn="neg"))
            else:
                self.instrs.append(Instr("reduce", out, (x,), fn=fn))
            count = xv.numel
        else:
            keep = tuple(1 if d in [dd % len(xv.shape) for dd in dims] else s
                         for d, s in enumerate(xv.shape))
            dest = torch.arange(math.prod(keep)).reshape(keep).expand(xv.shape).reshape(-1)
            base = self.lit({"sum": 0.0, "max": -math.inf, "min": math.inf}[fn], val.shape)
            out = self._segment(fn, base, x, dest, math.prod(keep), val.shape)
            count = xv.numel // math.prod(keep)
        if name == "mean":
            return self.elementwise("mul", [out, self.lit(1.0 / count)], val.shape)
        return out

    def _segment(self, fn, base, vals, dest, n_out, shape) -> int:
        """out[o] = base[o] (+ or max) the elements of ``vals`` whose
        destination is ``o``, in their order."""
        order = torch.sort(dest, stable=True).indices
        starts = torch.zeros(n_out + 1, dtype=torch.int64)
        starts[1:] = torch.cumsum(torch.bincount(dest, minlength=n_out), 0)
        if fn == "min":
            raise Decline("a minimum over a dimension")
        out = self.out(shape, "f")
        self.instrs.append(Instr("segment", out, (base, vals), fn=fn,
                                 maps=(self.index_map(starts), self.index_map(order))))
        return out

    def scatter_add(self, name, node, val):
        raw = node.args
        base = self.env[raw[0]]
        shape = self.values[base].shape
        numel = self.values[base].numel
        arange = torch.arange(1, numel + 1, dtype=torch.float64).reshape(shape)

        def const_index(a):
            vid = self.env[a]
            if not self.is_const(vid):
                raise Decline("a scatter index that depends on the position")
            return self.real(vid)

        if name == "index_put":
            accumulate = raw[3] if len(raw) > 3 else node.kwargs.get("accumulate", False)
            if not accumulate:
                raise Decline("index_put without accumulate")
            idx = [None if a is None else const_index(a) for a in raw[1]]
            dest = torch.ops.aten.index.Tensor(arange, idx)
            src = self.env[raw[2]]
        else:
            dim = raw[1]
            alpha = node.kwargs.get("alpha", raw[4] if len(raw) > 4 else 1)
            dest = torch.index_select(arange, dim, const_index(raw[2]).to(torch.int64))
            src = self.scaled(self.env[raw[3]], alpha)
        if tuple(dest.shape) != self.values[src].shape:
            if self.values[src].numel != 1:
                raise Decline("a scatter whose updates broadcast")
            src = self.alias(src, tuple(dest.shape))
        flat = dest.reshape(-1).to(torch.int64) - 1
        return self._segment("sum", base, src, flat, numel, val.shape)

    def matmul(self, name, a, b, val):
        av, bv = self.values[a], self.values[b]
        if name == "mv" and (len(av.shape) != 2 or len(bv.shape) != 1):
            raise Decline("aten.mv of unexpected ranks")
        if name == "mm" and (len(av.shape) != 2 or len(bv.shape) != 2):
            raise Decline("aten.mm of unexpected ranks")
        out = self.out(val.shape, "f")
        self.instrs.append(Instr(name, out, (a, b)))
        return out


# --------------------------------------------------------------------------
# Dead code, constants, slots
# --------------------------------------------------------------------------

def _live(values, instrs, outs):
    """The ops the outputs need, in order."""
    live_v = set(outs)
    live_b = {values[v].buf for v in outs if values[v].buf >= 0}
    keep = []
    for ins in reversed(instrs):
        ov = values[ins.out]
        if ins.out in live_v or (ov.buf >= 0 and ov.buf in live_b):
            keep.append(ins)
            for v in ins.ins + ins.maps:
                live_v.add(v)
                if values[v].buf >= 0:
                    live_b.add(values[v].buf)
    return keep[::-1]


def _pack_consts(values, instrs, device):
    """Offsets of the constants the ops read, and their float32 parts (an
    index as its int32 bits, a flag as 0/1)."""
    parts, offs, total = [], {}, 0
    for ins in instrs:
        for vid in ins.ins + ins.maps:
            v = values[vid]
            if v.kind != "const":
                continue
            key = id(v.data)
            if key not in offs:
                d = v.data.reshape(-1).contiguous()
                if v.dtype == "i":
                    part = d.to(torch.int32).contiguous().view(torch.float32)
                else:
                    part = d.to(torch.float32)
                offs[key] = total
                parts.append(part.to(device).contiguous())
                total += part.numel()
            v.off = offs[key]
    return parts, total


def _reads(values, ins) -> List[Tuple[int, bool]]:
    """Every value ``ins`` reads, with whether it reads it at the op's own
    element: an elementwise input (or a segment sum's base) of the
    output's shape, or a reduction's input."""
    if ins.op == "reduce":
        return [(ins.ins[0], True)]
    shape = values[ins.out].shape
    if ins.op == "ew":
        return [(v, values[v].shape == shape) for v in ins.ins]
    if ins.op == "segment":
        base, vals = ins.ins
        return [(base, values[base].shape == shape), (vals, False)]
    return [(v, False) for v in ins.ins]  # gather sources, matmul operands


def _loop_shape(values, ins) -> Optional[Tuple[int, ...]]:
    """The elements a loop runs ``ins`` over, or None for a one-element op."""
    v = values[ins.ins[0] if ins.op == "reduce" else ins.out]
    return v.shape if v.numel > 1 else None


def _thin_mv(values, ins) -> bool:
    """A matrix-vector product of a few outputs over long sums."""
    return (ins.op == "mv" and 1 < values[ins.out].numel <= THIN_MV_OUTPUTS
            and values[ins.ins[0]].shape[-1] >= 32)


def _fuse(values, instrs, grad: int) -> List[Step]:
    """The program's steps. An element-wise op (or a full reduction) joins
    the open loop where it runs over the same shape and reads nothing that
    loop computes at another element nor its reductions' totals; else the
    loop closes and a new one opens. A one-element op that reads nothing
    of the open loop runs before it, else after it. Then each buffer a
    loop computes and only that loop reads, element by element, becomes
    ``local``; the gradient is written from its loop where it can be."""
    steps: List[Step] = []
    loop: Optional[Step] = None
    made: set = set()  # the open loop's buffers and its reductions' outputs

    for ins in instrs:
        reads = _reads(values, ins)
        shape = _loop_shape(values, ins)
        thin = _thin_mv(values, ins)
        if shape is None or thin:
            if any(values[v].buf in made for v, _ in reads):
                steps.append(loop)
                loop, made = None, set()
            steps.append(Step(values[ins.out].shape if thin else None, [ins], rows=thin))
            continue
        if loop is not None and (loop.shape != shape or any(
                values[v].buf in made and not here for v, here in reads)):
            steps.append(loop)
            loop, made = None, set()
        if loop is None:
            loop = Step(shape, [])
        loop.instrs.append(ins)
        made.add(values[ins.out].buf)
    if loop is not None:
        steps.append(loop)

    home = {}  # buffer -> the loop that computes it
    for k, st in enumerate(steps):
        if st.shape is not None and not st.rows:
            for ins in st.instrs:
                if ins.op != "reduce":
                    home[values[ins.out].buf] = k
    kept = set()  # buffers read at another element or outside their loop
    for k, st in enumerate(steps):
        for ins in st.instrs:
            for v, here in _reads(values, ins):
                b = values[v].buf
                if b in home and not (home[b] == k and here):
                    kept.add(b)
    gb = values[grad].buf
    if values[grad].kind == "slot" and gb in home:
        st = steps[home[gb]]
        if st.shape == values[grad].shape:
            st.g_store = True
        else:
            kept.add(gb)
    for v in values:
        if v.kind == "slot" and v.buf in home and v.buf not in kept:
            v.kind = "local"
    return steps


def _allocate(values, steps, outs) -> int:
    """Scratch offsets: each buffer that keeps a slot takes one from its
    step to its last reader; a slot is reused once free, never within the
    step that reads it (a loop counts as one step: its inputs stay live to
    its end). Returns the scratch floats of one chain."""
    last = {}
    for k, st in enumerate(steps):
        for ins in st.instrs:
            for v in ins.ins + ins.maps:
                if values[v].kind == "slot":
                    last[values[v].buf] = k
    for v in outs:
        if values[v].kind == "slot":
            last[values[v].buf] = len(steps)
    sizes, slot_of, free = [], {}, []
    for k, st in enumerate(steps):
        for ins in st.instrs:
            ov = values[ins.out]
            if ov.kind == "slot" and ov.buf not in slot_of:
                fits = [s for s in free if sizes[s] >= ov.numel]
                if fits:
                    s = min(fits, key=lambda x: sizes[x])
                elif free:
                    s = max(free, key=lambda x: sizes[x])
                    sizes[s] = ov.numel
                else:
                    s = len(sizes)
                    sizes.append(ov.numel)
                if s in free:
                    free.remove(s)
                slot_of[ov.buf] = s
                last.setdefault(ov.buf, k)
        for b, at in last.items():
            if at == k and b in slot_of and slot_of[b] not in free:
                free.append(slot_of[b])
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    for v in values:
        if v.kind == "slot" and v.buf in slot_of:
            v.off = int(starts[slot_of[v.buf]])
    return int(starts[-1])


def _flops(values, ins) -> int:
    """Operations of one op (a transcendental counted as one)."""
    out = values[ins.out]
    if ins.op == "ew":
        return out.numel
    if ins.op == "reduce":
        return values[ins.ins[0]].numel
    if ins.op == "segment":
        return values[ins.ins[1]].numel
    if ins.op == "mv":
        return 2 * math.prod(values[ins.ins[0]].shape)
    if ins.op == "mm":
        return 2 * math.prod(values[ins.ins[0]].shape) * values[ins.ins[1]].shape[1]
    if ins.op == "dot":
        return 2 * values[ins.ins[0]].numel
    return 0


# --------------------------------------------------------------------------
# Emit
# --------------------------------------------------------------------------

_HELPERS = r"""#ifndef LMC_AUTOSPEC_HELPERS
#define LMC_AUTOSPEC_HELPERS
#include <math_constants.h>
namespace lmc {
__device__ __forceinline__ float ax_warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
// PyTorch's CPU log_sigmoid_backward
__device__ __forceinline__ float ax_log_sigmoid_bw(float g, float x) {
    const bool neg = x < 0.0f;
    const float z = expf(-fabsf(x));
    return g * ((neg ? 1.0f : 0.0f) - (neg ? 1.0f : -1.0f) * (z / (1.0f + z)));
}
// PyTorch's CPU logaddexp
__device__ __forceinline__ float ax_logaddexp(float a, float b) {
    if (isinf(a) && a == b) return a;
    const float m = fmaxf(a, b);
    return m + log1pf(expf(-fabsf(a - b)));
}
}  // namespace lmc
#endif
"""


def _flit(x: float) -> str:
    x = float(np.float32(x))
    if math.isnan(x):
        return "CUDART_NAN_F"
    if math.isinf(x):
        return "CUDART_INF_F" if x > 0 else "(-CUDART_INF_F)"
    return f"({x:.9e}f)"


_REDUCE = {"sum": ("0.0f", "{a} + {b}", "warp_sum"),
           "max": ("(-CUDART_INF_F)", "fmaxf({a}, {b})", "ax_warp_max")}


class _Emitter:
    def __init__(self, prog: Program):
        self.p = prog
        self.lines: List[str] = []
        self.step: Optional[Step] = None  # the step being emitted
        self.temps: set = set()  # the buffers the open loop holds in registers
        self.totals: List[str] = []  # the open loop's warp sums, after it

    def v(self, vid) -> Value:
        return self.p.values[vid]

    def rd(self, vid, e: str) -> str:
        """Element ``e`` of a value from where it is stored, as a float."""
        v = self.v(vid)
        if v.kind == "local" or v.buf in self.temps:
            raise AssertionError(f"value {vid} read at another element of its loop")
        if v.kind == "reg":
            return f"r{v.buf}"
        if v.kind == "lit":
            return _flit(v.lit)
        if v.kind == "q":
            return f"q[{e}]"
        if v.kind == "slot":
            return f"s[{v.off} + ({e})]"
        if v.dtype == "i":
            return f"(float)__float_as_int(lam[{v.off} + ({e})])"
        return f"lam[{v.off} + ({e})]"

    def el(self, vid, oshape) -> str:
        """``vid`` at the loop's element ``i`` (broadcast to ``oshape``):
        its register where the loop computed it, else where it is stored."""
        if self.v(vid).buf in self.temps:
            return f"t{self.v(vid).buf}"
        return self.rd(vid, self.bidx(vid, oshape))

    def idx(self, vid, e: str) -> str:
        """Element ``e`` of an index map."""
        return f"__float_as_int(lam[{self.v(vid).off} + ({e})])"

    def bidx(self, vid, oshape) -> str:
        """The flat index of ``vid``'s element broadcast to the output
        element ``i`` (``i0``, ``i1`` its row and column)."""
        ishape = self.v(vid).shape
        if math.prod(ishape) == 1:
            return "0"
        if tuple(ishape) == tuple(oshape):
            return "i"
        ro = len(oshape)
        padded = (1,) * (ro - len(ishape)) + tuple(ishape)
        strides = [math.prod(padded[d + 1:]) for d in range(ro)]
        names = ["i"] if ro == 1 else ["i0", "i1"]
        terms = [f"{names[d]} * {strides[d]}" for d in range(ro) if padded[d] != 1]
        return " + ".join(terms) or "0"

    def operands(self, ins, reg: bool):
        """Element readers ``(a(t), b(t), K)`` of a matmul's operands for
        the output element ``i`` (``i0``, ``i1``), or for a one-element
        output."""
        a, b = ins.ins
        av, bv = self.v(a), self.v(b)
        K = av.shape[-1] if av.shape else 1
        if ins.op == "dot" or (reg and ins.op == "mv"):
            return (lambda t: self.rd(a, t)), (lambda t: self.rd(b, t)), K
        if ins.op == "mv":
            return (lambda t: self.rd(a, f"i * {K} + {t}")), (lambda t: self.rd(b, t)), K
        P = bv.shape[1]
        if reg:
            return (lambda t: self.rd(a, t)), (lambda t: self.rd(b, f"{t} * {P}")), K
        return ((lambda t: self.rd(a, f"i0 * {K} + {t}")),
                (lambda t: self.rd(b, f"{t} * {P} + i1")), K)

    def emit(self, ins) -> List[str]:
        """The statements of one op of ``self.step``: a one-element op, a
        thin matrix-vector product, or within a loop the op's element
        ``i`` (into its register ``t<buf>``; a reduction adds it to the
        lane's sum)."""
        if self.step.rows:
            return self.rows(ins)
        if self.step.shape is None:
            return self.scalar(ins)
        shape = self.step.shape
        out = self.v(ins.out)
        t = f"t{out.buf}"
        if ins.op == "reduce":
            init, comb, red = _REDUCE[ins.fn]
            acc = f"a{out.buf}"
            self.lines.append(f"float {acc} = {init};")
            self.totals.append(f"const float r{out.buf} = {red}({acc});")
            return [f"{acc} = {comb.format(a=acc, b=self.el(ins.ins[0], shape))};"]
        if ins.op == "ew":
            _, tmpl, _ = _EW[ins.fn]
            params = {f"p{k}": _flit(x) for k, x in enumerate(ins.params)}
            expr = tmpl.format(*[self.el(x, shape) for x in ins.ins], **params)
            return [f"const float {t} = {expr};"]
        if ins.op == "gather":
            lines = [f"float {t} = 0.0f;"]
            for src, mp in zip(ins.ins, ins.maps):
                lines.append(f"{{ const int m = {self.idx(mp, 'i')}; "
                             f"if (m >= 0) {t} = {self.rd(src, 'm')}; }}")
            return lines
        if ins.op == "segment":
            base, vals = ins.ins
            starts, members = ins.maps
            comb = _REDUCE[ins.fn][1].format(a=t, b=self.rd(vals, self.idx(members, "k")))
            return [f"float {t} = {self.el(base, shape)};",
                    f"for (int k = {self.idx(starts, 'i')}, k1 = {self.idx(starts, 'i + 1')}; "
                    f"k < k1; ++k) {t} = {comb};"]
        if ins.op in ("mv", "mm"):
            ra, rb, K = self.operands(ins, reg=False)
            return [f"float {t} = 0.0f;",
                    f"for (int j = 0; j < {K}; ++j) {t} = fmaf({ra('j')}, {rb('j')}, {t});"]
        raise AssertionError(ins.op)

    def loop(self, st: Step):
        """One fused loop: each element's values in registers, the kept
        ones stored to their slots, reductions added per lane and summed
        across the warp after the loop."""
        shape = st.shape
        body = []
        if len(shape) == 2:
            body += [f"const int i0 = i / {shape[1]}, i1 = i - i0 * {shape[1]};",
                     "(void)i0; (void)i1;"]
        for ins in st.instrs:
            out = self.v(ins.out)
            body += self.emit(ins)
            if ins.op == "reduce":
                continue
            self.temps.add(out.buf)
            if out.kind == "slot":
                body.append(f"s[{out.off} + i] = t{out.buf};")
            if st.g_store and out.buf == self.v(self.p.grad).buf:
                body.append(f"g[i] = t{out.buf};")
        self.lines += ([f"for (int i = lane; i < {math.prod(shape)}; i += 32) {{"]
                       + ["    " + b for b in body] + ["}"] + self.totals + ["__syncwarp();"])
        self.temps.clear()
        self.totals = []

    def rows(self, ins):
        """A thin matrix-vector product: every lane adds its share of each
        output's sum (terms lane, lane + 32, ...), the warp sums them, and
        lane o stores output o."""
        a, b = ins.ins
        out = self.v(ins.out)
        M, K = out.numel, self.v(a).shape[-1]
        c = f"c{out.buf}"
        return [f"float {c}[{M}];",
                "#pragma unroll",
                f"for (int o = 0; o < {M}; ++o) {c}[o] = 0.0f;",
                f"for (int j = lane; j < {K}; j += 32) {{",
                f"    const float x = {self.rd(b, 'j')};",
                "#pragma unroll",
                f"    for (int o = 0; o < {M}; ++o) "
                f"{c}[o] = fmaf({self.rd(a, f'o * {K} + j')}, x, {c}[o]);",
                "}",
                "#pragma unroll",
                f"for (int o = 0; o < {M}; ++o) {{",
                f"    const float total = warp_sum({c}[o]);",
                f"    if (lane == o) s[{out.off} + o] = total;",
                "}",
                "__syncwarp();"]

    def scalar(self, ins):
        """An op with a one-element output, into its register ``r<buf>``."""
        name = f"r{self.v(ins.out).buf}"
        lines: List[str] = []
        if ins.op == "ew":
            _, tmpl, _ = _EW[ins.fn]
            params = {f"p{k}": _flit(x) for k, x in enumerate(ins.params)}
            expr = tmpl.format(*[self.rd(x, "0") for x in ins.ins], **params)
            lines.append(f"const float {name} = {expr};")
        elif ins.op == "reduce":
            x = ins.ins[0]
            init, comb, red = _REDUCE[ins.fn]
            acc = f"a{self.v(ins.out).buf}"
            lines += [f"float {acc} = {init};",
                      f"for (int i = lane; i < {self.v(x).numel}; i += 32) "
                      f"{acc} = {comb.format(a=acc, b=self.rd(x, 'i'))};",
                      f"const float {name} = {red}({acc});"]
        elif ins.op == "segment":
            base, vals = ins.ins
            starts, members = ins.maps
            comb = _REDUCE[ins.fn][1].format(a=name, b=self.rd(vals, self.idx(members, "k")))
            lines += [f"float {name} = {self.rd(base, '0')};",
                      f"for (int k = {self.idx(starts, '0')}, k1 = {self.idx(starts, '1')}; "
                      f"k < k1; ++k) {name} = {comb};"]
        elif ins.op == "gather":
            lines.append(f"float {name} = 0.0f;")
            for src, mp in zip(ins.ins, ins.maps):
                lines.append(f"{{ const int m = {self.idx(mp, '0')}; "
                             f"if (m >= 0) {name} = {self.rd(src, 'm')}; }}")
        elif ins.op in ("mv", "mm", "dot"):
            ra, rb, K = self.operands(ins, reg=True)
            acc = f"a{self.v(ins.out).buf}"
            lines += [f"float {acc} = 0.0f;",
                      f"for (int t = lane; t < {K}; t += 32) "
                      f"{acc} = fmaf({ra('t')}, {rb('t')}, {acc});",
                      f"const float {name} = warp_sum({acc});"]
        else:
            raise AssertionError(ins.op)
        return lines

    def body(self) -> str:
        p = self.p
        for st in p.steps:
            self.step = st
            if st.shape is None or st.rows:
                self.lines += self.emit(st.instrs[0])
            else:
                self.loop(st)
        if not any(st.g_store for st in p.steps):
            g = self.v(p.grad)
            self.lines += [f"for (int i = lane; i < {p.ndim}; i += 32) g[i] = "
                           f"{self.rd(p.grad, 'i' if g.numel > 1 else '0')};",
                           "__syncwarp();"]
        self.lines.append(f"return {self.rd(p.logp, '0')};")
        inner = "\n".join("    " + ln for ln in self.lines)
        loops = sum(st.shape is not None and not st.rows for st in p.steps)
        return (f"constexpr int kScratchFloats = {p.scratch_floats};\n"
                f"// {p.name}: {len(p.instrs)} ops in {loops} loops, {p.const_floats} "
                "constant floats\n"
                "__device__ __noinline__ float eval(const float* __restrict__ q,\n"
                "                                   float* __restrict__ g,\n"
                "                                   const float* __restrict__ lam, int n,\n"
                "                                   int lane, float* __restrict__ s) {\n"
                "    (void)n; (void)lam; (void)s;\n"
                f"{inner}\n}}\n")


def header_source(prog: Program) -> str:
    """The header the trajectory kernels' generated build includes:
    ``lmc::autobody`` with the body, its scratch size and the global
    scratch pointer, ``autospec_bind_scratch`` to set it and
    ``autospec_scratch_in_smem``, where the last launch put the scratch
    rows (1 shared memory, 0 the global scratch)."""
    return (f"// Generated by littlemcmc_torch/ops/autospec.py: the body of {prog.name}\n"
            + _HELPERS + "namespace lmc {\nnamespace autobody {\n" + prog.body
            + "__device__ float* scratch;  // (warps, kScratchFloats)\n"
            "}  // namespace autobody\n}  // namespace lmc\n"
            'extern "C" int autospec_bind_scratch(float* p, void* stream) {\n'
            "    (void)stream;\n"
            "    return (int)cudaMemcpyToSymbol(lmc::autobody::scratch, &p, sizeof(p));\n}\n"
            'extern "C" int autospec_scratch_in_smem(void) { return lmc::last_scratch_in_smem; }\n')


def probe_header(progs: Sequence[Program]) -> str:
    """The header of the probe kernel (``csrc/autospec_probe.cu``): each
    body in its own namespace and ``lmc::autoprobe::eval`` choosing one."""
    parts = ["// Generated by littlemcmc_torch/ops/autospec.py: the probe's bodies\n", _HELPERS,
             "namespace lmc {\n"]
    for k, prog in enumerate(progs):
        parts.append(f"namespace autobody_{k} {{\n{prog.body}}}  // namespace autobody_{k}\n")
    cases = "".join(f"        case {k}: return autobody_{k}::eval(q, g, lam, n, lane, s);\n"
                    for k in range(len(progs)))
    parts.append("namespace autoprobe {\n"
                 "__device__ float eval(int which, const float* q, float* g, const float* lam,\n"
                 "                      int n, int lane, float* s) {\n"
                 f"    switch (which) {{\n{cases}        default: return CUDART_NAN_F;\n"
                 "    }\n}\n}  // namespace autoprobe\n}  // namespace lmc\n")
    return "".join(parts)


# --------------------------------------------------------------------------
# The numpy interpreter
# --------------------------------------------------------------------------

def interpret(prog: Program, q: np.ndarray):
    """``(logp, grad)`` of the fused program at one chain's ``q`` in numpy
    float32, step by step as the kernel runs it: a loop's values in its
    registers (dropped at its end), the kept ones through the scratch
    slots, index maps and segment sums. A slot overwritten while its value
    is live, a register read outside its loop or a wrong map shows here."""
    consts = (torch.cat(prog.const_parts).cpu().numpy() if prog.const_parts
              else np.zeros(0, np.float32))
    scratch = np.full(prog.scratch_floats, np.nan, np.float32)
    regs: Dict[int, np.float32] = {}
    temps: Dict[int, np.ndarray] = {}  # the open loop's registers, by buffer
    q = np.asarray(q, np.float32)
    g_out = None

    def read(vid, as_int=False):
        v = prog.values[vid]
        if v.buf in temps and v.kind in ("slot", "local"):
            a = temps[v.buf]
        elif v.kind == "local":
            raise AssertionError(f"value {vid} read outside its loop")
        elif v.kind == "q":
            a = q
        elif v.kind == "const":
            a = consts[v.off:v.off + v.numel]
            a = a.view(np.int32) if v.dtype == "i" else a
        elif v.kind == "slot":
            a = scratch[v.off:v.off + v.numel].copy()
        elif v.kind == "reg":
            a = np.full(v.numel, regs[v.buf], np.float32)
        else:
            a = np.full(v.numel, v.lit, np.float32)
        a = a.reshape(v.shape)
        return a if as_int else a.astype(np.float32)

    def write(vid, a, in_loop):
        v = prog.values[vid]
        a = np.asarray(a, np.float32)
        if v.kind == "reg":
            regs[v.buf] = np.float32(a.reshape(-1)[0])
            return
        a = np.broadcast_to(a, v.shape).reshape(-1).copy()
        if in_loop:
            temps[v.buf] = a
        if v.kind == "slot":
            scratch[v.off:v.off + v.numel] = a

    with np.errstate(all="ignore"):
        for st in prog.steps:
            temps.clear()
            for ins in st.instrs:
                out = prog.values[ins.out]
                if ins.op == "ew":
                    fn = _EW[ins.fn][2]
                    res = np.broadcast_to(fn(*[read(x) for x in ins.ins], *ins.params),
                                          out.shape)
                elif ins.op == "reduce":
                    x = read(ins.ins[0]).reshape(-1)
                    res = x.sum(dtype=np.float32) if ins.fn == "sum" else x.max()
                elif ins.op == "segment":
                    res = np.broadcast_to(read(ins.ins[0]), out.shape).reshape(-1).copy()
                    vals = read(ins.ins[1]).reshape(-1)
                    starts = read(ins.maps[0], True).reshape(-1)
                    members = read(ins.maps[1], True).reshape(-1)
                    for o in range(out.numel):
                        for k in range(starts[o], starts[o + 1]):
                            res[o] = (res[o] + vals[members[k]] if ins.fn == "sum"
                                      else max(res[o], vals[members[k]]))
                elif ins.op == "gather":
                    res = np.zeros(out.numel, np.float32)
                    for src, mp in zip(ins.ins, ins.maps):
                        m = read(mp, True).reshape(-1)
                        sel = m >= 0
                        res[sel] = read(src).reshape(-1)[m[sel]]
                else:
                    res = np.dot(read(ins.ins[0]), read(ins.ins[1])).astype(np.float32)
                write(ins.out, res, st.shape is not None and not st.rows
                      and ins.op != "reduce")
            if st.g_store:
                g_out = temps[prog.values[prog.grad].buf].reshape(prog.values[prog.grad].shape)
        temps.clear()
        grad = read(prog.grad) if g_out is None else g_out
    return np.float32(read(prog.logp).reshape(())), grad


# --------------------------------------------------------------------------
# The spec
# --------------------------------------------------------------------------

def _lower(gm: torch.fx.GraphModule, ndim: int, name: str, device) -> Program:
    low = _Lowering(gm, ndim)
    lp, g = low.run()
    instrs = _live(low.values, low.instrs, (lp, g))
    parts, n_consts = _pack_consts(low.values, instrs, device)
    steps = _fuse(low.values, instrs, g)
    scratch = _allocate(low.values, steps, (lp, g))
    if scratch > MAX_SCRATCH_FLOATS:
        raise Decline(f"{scratch} scratch floats a chain (the kernels take "
                      f"{MAX_SCRATCH_FLOATS})")
    instrs = [ins for st in steps for ins in st.instrs]
    prog = Program(name=name, ndim=ndim, values=low.values, instrs=instrs, logp=lp, grad=g,
                   const_parts=parts, const_floats=n_consts, scratch_floats=scratch,
                   flops=sum(_flops(low.values, i) for i in instrs), graph=gm, steps=steps)
    prog.body = _Emitter(prog).body()
    prog.digest = hashlib.sha256(prog.body.encode()).hexdigest()[:16]
    return prog


def _model_name(fn) -> str:
    owner = getattr(fn, "__self__", None)
    base = getattr(fn, "__qualname__", None) or type(fn).__name__
    return base if owner is None or "." in base else f"{type(owner).__name__}.{base}"


def make_trajectory_spec(logp_dlogp_func: Optional[Callable] = None, ndim: Optional[int] = None,
                         *, logp_fn: Optional[Callable] = None, device=None,
                         name: Optional[str] = None) -> TrajectorySpec:
    """A :class:`~littlemcmc_torch.ops.TrajectorySpec` with a generated
    body (``body="auto"``) from a torch model: ``logp_dlogp_func(q) ->
    (logp, grad)`` or a scalar ``logp_fn(q)`` (differentiated with
    ``torch.func.grad_and_value``), one chain's ``(ndim,)`` position in,
    ``device`` (default the card) where its constants live. Raises
    :class:`Decline` where the model does not lower (see the module
    docstring) and ``ValueError`` for a wrong signature. The spec's body is
    probed (:func:`probe_spec`) before its first kernel launch."""
    if (logp_dlogp_func is None) == (logp_fn is None):
        raise ValueError("provide exactly one of logp_dlogp_func / logp_fn")
    if ndim is None:
        raise ValueError("ndim is required")
    ndim = int(ndim)
    if ndim > MAX_NDIM:
        raise Decline(f"{ndim} parameters (the kernels' generated bodies take "
                      f"n <= {MAX_NDIM})")
    dev = resolve_device(device)
    user = logp_fn if logp_fn is not None else logp_dlogp_func
    fn = from_logp_fn(logp_fn) if logp_fn is not None else logp_dlogp_func
    prog = _lower(_trace(fn, ndim, dev), ndim, name or _model_name(user), dev)
    return TrajectorySpec("auto", tuple(prog.const_parts), ndim, packable=False, auto=prog)


# --------------------------------------------------------------------------
# Build, probe, launch
# --------------------------------------------------------------------------

_SCRATCH: Dict[str, torch.Tensor] = {}


def kernel_library(spec: TrajectorySpec, kernel: str, device, warps: int):
    """The library of ``kernel`` with ``spec``'s generated body, built at
    its first use, its scratch bound for ``warps`` warps; the body is
    probed first (:func:`probe_spec`). Raises on a failed build, launch or
    probe."""
    from . import _build

    prog = spec.auto
    if not prog.probed:
        probe_spec(spec)
    if kernel not in prog.libraries:
        prog.libraries[kernel] = _build.load_generated(kernel, header_source(prog))
    lib, path = prog.libraries[kernel]
    need = (warps + 32) * max(prog.scratch_floats, 1)
    have = _SCRATCH.get(path)
    if have is None or have.numel() < need or have.device != torch.device(device):
        buf = torch.empty(need, dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            err = lib.autospec_bind_scratch(buf.data_ptr(), None)
        if err != 0:
            raise RuntimeError(f"binding the generated body's scratch failed: CUDA error "
                               f"{err} ({lib.cuda_error_string(err).decode()})")
        _SCRATCH[path] = buf
    return lib


def scratch_in_smem(spec: TrajectorySpec, kernel: str) -> bool:
    """Whether the last launch of ``kernel`` with ``spec``'s generated body
    put its scratch rows in shared memory (else in the global scratch);
    ``kernel`` ``autospec_probe`` reads the last probe launch. Raises
    where that library was not built."""
    from . import _build

    if kernel == "autospec_probe":
        lib, _ = _build.load_generated("autospec_probe", probe_header([spec.auto]))
    elif kernel in spec.auto.libraries:
        lib = spec.auto.libraries[kernel][0]
    else:
        raise RuntimeError(f"{kernel} has not been built with the body of {spec.auto.name}")
    return bool(lib.autospec_scratch_in_smem())


def _probe_inputs(n: int, device) -> torch.Tensor:
    """The JAX probe's inputs (``autospec.py:527-532``): 8 rows of
    ``RandomState(0).randn``, scaled 0.1, 1, 5, 0.1, ..."""
    q = np.random.RandomState(0).randn(PROBE_CHAINS, n).astype(np.float32)
    q *= np.asarray(PROBE_SCALES, np.float32)[np.arange(PROBE_CHAINS) % len(PROBE_SCALES), None]
    return torch.from_numpy(q).to(device)


def _spec_device(spec: TrajectorySpec) -> torch.device:
    return (spec.kernel_consts.device if spec.kernel_consts is not None
            else torch.device("cuda"))


def _launch_probe(lib, which: int, spec: TrajectorySpec, q: torch.Tensor):
    """One launch of the probe kernel: body ``which`` of ``lib`` at ``q``
    ``(C, n)``; returns ``(logp, grad)``."""
    from . import _build

    prog = spec.auto
    C, n = q.shape
    dev = q.device
    lp = torch.empty(C, dtype=torch.float32, device=dev)
    g = torch.empty(C, n, dtype=torch.float32, device=dev)
    scratch = torch.empty(C * max(prog.scratch_floats, 1), dtype=torch.float32, device=dev)
    consts = spec.kernel_consts
    _build.launch("autospec_probe",
                  [q.data_ptr(), consts.data_ptr() if consts is not None else None,
                   scratch.data_ptr(), lp.data_ptr(), g.data_ptr()],
                  [which, n, C, prog.scratch_floats], [], dev, lib=lib)
    probe_spec.launches += 1
    return lp, g


def run_probe(spec: TrajectorySpec, q: Optional[torch.Tensor] = None):
    """The probe kernel alone with ``spec``'s body at ``q`` (default the
    probe's inputs): ``(logp, grad)``, unchecked."""
    from . import _build

    lib, _ = _build.load_generated("autospec_probe", probe_header([spec.auto]))
    q = _probe_inputs(spec.ndim, _spec_device(spec)) if q is None else q
    return _launch_probe(lib, 0, spec, q)


def probe_spec(spec: TrajectorySpec) -> bool:
    """Evaluate the generated body alone on the card against its plain
    version; True, or raise (see :func:`probe_specs`)."""
    probe_specs([spec])
    return True


def probe_specs(specs: Sequence[TrajectorySpec]) -> Dict[str, dict]:
    """Build the probe kernel with every spec's body (one ``nvcc``) and run
    each on the JAX probe's inputs (:func:`_probe_inputs`), held against
    the plain version at rtol 5e-3, atol 1e-3 (NaN where both are NaN).
    Raises ``RuntimeError`` naming the model on a mismatch (the JAX probe
    returns False there and its ``sample()`` falls back; this port does not
    fall back), and on the CPU, since the body runs on the card. Returns
    each model's largest errors."""
    from . import _build

    for spec in specs:
        if spec.body != "auto":
            raise ValueError(f"probe_spec takes generated specs, not the {spec.body} body")
        dev = spec.kernel_consts.device if spec.kernel_consts is not None else None
        if dev is None or dev.type != "cuda":
            dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
        if dev.type != "cuda":
            raise RuntimeError("probe_spec runs the generated body on the CUDA card; there is "
                               "none here")
    progs = [s.auto for s in specs]
    lib, _ = _build.load_generated("autospec_probe", probe_header(progs))
    report = {}
    for k, spec in enumerate(specs):
        prog = spec.auto
        q = _probe_inputs(prog.ndim, _spec_device(spec))
        lp, g = _launch_probe(lib, k, spec, q)
        want_lp, want_g = prog.plain(q)
        ok = (torch.allclose(lp, want_lp, rtol=PROBE_RTOL, atol=PROBE_ATOL, equal_nan=True)
              and torch.allclose(g, want_g, rtol=PROBE_RTOL, atol=PROBE_ATOL, equal_nan=True))
        report[prog.name] = {"logp_max_abs": float((lp - want_lp).abs().nan_to_num().max()),
                             "grad_max_abs": float((g - want_g).abs().nan_to_num().max())}
        if not ok:
            raise RuntimeError(
                f"the generated body of {prog.name} disagrees with its plain version on the "
                f"probe's inputs (rtol {PROBE_RTOL}, atol {PROBE_ATOL}; "
                f"{report[prog.name]}): a fault of the lowering, not of the model")
        prog.probed = True
    return report


probe_spec.launches = 0


def _auto_spec(user_fn, ndim: int, is_logp_only: bool, device: str):
    """The generated spec, or None with an info log line where the model
    declines at trace time (:class:`Decline`). Any other exception is a
    fault of this module or of the build and propagates: it never leads
    to the tree."""
    try:
        if is_logp_only:
            return make_trajectory_spec(ndim=ndim, logp_fn=user_fn, device=device)
        return make_trajectory_spec(user_fn, ndim, device=device)
    except Decline as e:
        _log.info("Model not auto-lowerable to the CUDA trajectory kernels (%s); "
                  "using the tensor-op tree.", e)
        return None


_cached_auto_spec = functools.lru_cache(maxsize=8)(_auto_spec)


def try_auto_spec(user_fn, ndim: int, is_logp_only: bool = False, device=None):
    """The generated spec of a user model for ``sample()``, or None (with
    an info log line) where it declines at trace time; any other fault
    raises. Memoized on the callable, as in the JAX package; an unhashable
    callable is traced each call."""
    dev = str(resolve_device(device))
    try:
        hash(user_fn)
    except TypeError:
        return _auto_spec(user_fn, int(ndim), bool(is_logp_only), dev)
    return _cached_auto_spec(user_fn, int(ndim), bool(is_logp_only), dev)
