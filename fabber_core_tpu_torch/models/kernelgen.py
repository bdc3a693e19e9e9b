"""Derivation of a model for the whole-loop kernel, and the CUDA model
functor generated from it.

Port of fabber_core_tpu/models/base.py derive_time_local_eval
(:254-352). The JAX package traces a plugin's plain ``evaluate`` into a
jaxpr, checks it against a Mosaic-safe primitive allowlist and lets the
Pallas kernel vmap it over the voxel lanes. A CUDA kernel cannot trace
a torch function, so here the trace is turned into C++:

  probe     torch.fx make_fx (fake tensors, so value-dependent control
            flow fails the trace; tensors the model closes over, such as
            a convolution matrix, enter as real constants) of
            model.evaluate(params [P], EvalContext(data=<forbidden>,
            coords=<forbidden>, suppdata=supp [S] or None, nt=nt)); every
            use of a forbidden sentinel raises, a presence check like
            ``ctx.data is None`` included, since it takes the data branch;
  walk      each aten node of the graph against an allowlist (the torch
            counterpart of _KERNEL_SAFE_PRIMITIVES), with the time axis
            tracked by where it came from: arange(ctx.nt) becomes the
            sample index t. Ops whose operands are all constants (and
            the index) are computed on the CPU at trace time too, a
            rounding division among them. The per-sample walk (_Gen)
            admits a model whose every op is time-local, contractions
            over non-time axes (dot, mv, mm, bmm of a batch of one:
            M @ p) unrolled; it rejects one that selects, slices,
            reverses, permutes the elements of or reduces along that
            axis, an op outside the allowlist (a custom
            autograd.Function or custom op among them) or an output that
            is not [nt]. Where it rejects, the full-time walk (_FullGen)
            admits the time-mixing ops of the JAX allowlist too (the
            torch counterparts of reduce_* over time, over time and other
            axes at once, rev, slice, concatenate, pad, and dot_general
            over time with a constant or with a second operand that
            depends on the parameters), and values with two time axes
            (outer(s, s), s[:, None] * s[None, :], s[:, None] * w[None,
            :] with w a constant of nt samples) where a reduction over
            one or both of them ends them; cumsum, sort, a gather by a
            tensor index and the rest stay refused, as they are in the
            JAX probe;
  generate  each node becomes lines of a C++ functor in a scalar type,
            the non-time axes unrolled. Values that depend on the
            parameters are of type S (a forward dual number in the
            kernel, csrc/dual.cuh), the others of type R (float in the
            kernel), so a value that does not depend on the parameters
            carries no tangent (one that does carries all P).

The per-sample walk's functor gives the signal at one sample
(``eval(m, supp, t, dt, jac)``, csrc/vb_device.cuh's contract), and the
whole-loop kernel runs it a voxel a thread. The full-time walk's
functor (``run``, csrc/fulltime.cuh's contract) is the TPU kernel's
generic full-time mode (fabber_core_tpu/ops/fused_loop_nl.py:37-46,
204-227): a warp serves one voxel and evaluates the whole time axis at
once, sample t on lane t mod 32; the lines between two time-mixing ops
run per lane in registers, and each value a time-mixing op reads is
stored in shared memory first; a value with two time axes is never
stored: a lane owns a sample of the axis a reduction keeps and a loop
inside its line runs the other, the elementwise lines folded into the
reduction. The kernel is the cooperative form of kernel 6
(csrc/fused_nl_loop.cuh, ops/_cuda.py "nl_loop_full"). A rejected model
is a route decision made before any launch, never a fallback after a
failure.

The same generator turns a model's ``time_signal(params, t)`` (P
scalar planes and a scalar t) into a functor, for time_signal plugins
that have no hand-written one (kernel_model()).
"""

import math
import operator
import re

import numpy as np
import torch

from .base import EvalContext


class _ProbeForbidden:
    """Probe stand-in for ctx.data/coords: every use raises. A plain
    None would let a model that presence-checks (``if ctx.data is None``)
    trace while computing another signal than the generic route, where
    data is bound."""

    def __init__(self, name):
        object.__setattr__(self, "_pf_name", name)

    def _pf_boom(self, *a, **k):
        raise TypeError(
            f"ctx.{object.__getattribute__(self, '_pf_name')} is not "
            "available to the data-free kernel tier")

    def __getattr__(self, name):
        self._pf_boom()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise TypeError("ctx.data/coords are not available to the "
                        "data-free kernel tier")


for _dunder in ("__getitem__", "__iter__", "__len__", "__array__",
                "__bool__", "__float__", "__int__", "__index__",
                "__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                "__rmul__", "__truediv__", "__rtruediv__", "__pow__",
                "__rpow__", "__neg__", "__abs__", "__matmul__",
                "__rmatmul__", "__lt__", "__le__", "__gt__", "__ge__",
                "__mod__", "__rmod__", "__call__"):
    setattr(_ProbeForbidden, _dunder, _ProbeForbidden._pf_boom)


class Rejected(Exception):
    """The trace holds something the kernel cannot evaluate per sample."""


class TimeLocalEval:
    """An accepted model: ``fn(params [P][, supp [S]]) -> [nt]`` (the
    model's evaluate over a data-free context, plain torch), its
    parameter and suppdata counts, the generated functor's C++ source
    (struct GenModel), the float32 operations the functor does per
    time sample for the value and for the P tangents (a full-time
    functor: per evaluation of the whole time axis), and (from evaluate
    only, else None) time_planes: the intermediates of the trace that
    carry the time axis, the JAX engine's measure of the generic mode's
    VMEM (fabber_core_tpu/models/base.py _count_time_planes), which the
    route gate's copy of its picker reads (ops/fused_loop_nl.py
    pick_nl_block). full_time: the functor is the full-time walk's
    (csrc/fulltime.cuh: a warp evaluates the whole time axis), with
    smem_floats floats of shared memory for the values its time-mixing
    ops read and consts, the float32 constants it reads from a device
    buffer (None: none). needed_ops: of value_ops + tangent_ops, those
    the function needs: all but the products by a constant's known zeros
    (a full-time contraction reads its matrix whole, a lower-triangular
    convolution's zeros too)."""

    def __init__(self, fn, nparams, nsupp, source, value_ops, tangent_ops,
                 time_planes=None, full_time=False, smem_floats=0,
                 consts=None, zero_ops=0):
        self.fn = fn
        self.time_planes = time_planes
        self.nparams = nparams
        self.nsupp = nsupp
        self.source = source
        self.value_ops = value_ops
        self.tangent_ops = tangent_ops
        self.needed_ops = value_ops + tangent_ops - zero_ops
        self.full_time = full_time
        self.smem_floats = smem_floats
        self.consts = consts
        # (kernel, Q) -> the loaded library of its kernel (ops/_cuda.py
        # build_generated), set where it is built
        self.libs = {}
        self._consts_on = {}

    def consts_on(self, device):
        """The constant buffer as a float32 tensor on device (None where
        the functor has none), copied once per device."""
        if self.consts is None:
            return None
        key = str(device)
        if key not in self._consts_on:
            self._consts_on[key] = torch.as_tensor(self.consts).to(device)
        return self._consts_on[key]

    @property
    def kernel(self):
        """The GEN_KERNELS key of the whole-loop kernel that runs this
        functor (ops/_cuda.py): "nl_loop_full" for a full-time one."""
        return "nl_loop_full" if self.full_time else "nl_loop"

    def __call__(self, pvec, *supp):
        return self.fn(pvec, *supp)


def derive_time_local_eval(model, nt, nparams, nsupp=0):
    """A TimeLocalEval if ``model.evaluate`` is data-free (it reads only
    the parameters, ctx.nt, static model config and, when the run has
    it, nsupp > 0, per-voxel ctx.suppdata) and every op it traces to is
    one the generator knows: the per-sample walk's functor where the
    model is time-local, else the full-time walk's where its time-mixing
    ops are the JAX allowlist's; else None."""
    fdata = _ProbeForbidden("data")
    fcoords = _ProbeForbidden("coords")

    def fn(pvec, *svec):
        # suppdata stays None when the run has none: the generic route
        # binds None too, so a model's `suppdata is None` branch is the
        # one that runs on both routes
        ctx = EvalContext(data=fdata, coords=fcoords,
                          suppdata=svec[0] if svec else None, nt=nt)
        return model.evaluate(pvec, ctx)

    args = [torch.zeros(nparams)] + ([torch.zeros(nsupp)] if nsupp else [])
    try:
        gm = _trace(fn, args)
    except Exception:   # a failed trace: the route says no
        return None
    for cls in (_Gen, _FullGen):
        try:
            gen = cls(gm, nparams, nsupp, nt)
            gen.bind_inputs(["m"] + (["supp"] if nsupp else []),
                            [(nparams,)] + ([(nsupp,)] if nsupp else []))
            out = gen.run()
            gen.finish(out, (nt,))
            source = gen.source()
        except Exception:   # a rejected op: the next walk, or no
            continue
        full = cls is _FullGen
        return TimeLocalEval(
            fn, nparams, nsupp, source, gen.value_ops, gen.tangent_ops,
            count_time_planes(gm, nt), full_time=full,
            smem_floats=gen.sh_floats if full else 0,
            consts=gen.const_values() if full else None,
            zero_ops=gen.zero_ops if full else 0)
    return None


def count_time_planes(gm, nt):
    """The nodes of a make_fx trace whose output carries the time axis (a
    dimension of length nt), at least 1: the count of JAX's
    _count_time_planes (jaxpr equation outputs with nt in their shape)
    over the port's own trace. The traces are not the same program (an
    aten op may stand for a pair of lax primitives), but on the models
    tests/test_torch_wide_nl.py and tests/test_torch_fulltime.py hold
    them against (a Gaussian, its suppdata form, exp sums of 1-5
    components; a baseline-centred biexponential, a convolution by a
    constant matrix, its suppdata-scaled form, a shift by slice and
    concatenation) the counts agree. The copy torch's trace makes where a
    constant enters (lift_fresh_copy) has no jaxpr equation and is not
    counted, nor are matmul's own reshapes of a vector (an unsqueeze into
    mm, the squeeze_ after it: jax's dot_general takes the vector); where
    jax writes more equations for one aten node (_lax_extra: stack's
    expand_dims of each operand, mean's division, an elementwise op's
    promotion of a lower-rank operand), they are counted too. On the
    twins of tests/test_torch_generic_ops.py (a family of the JAX
    allowlist each) the counts agree."""
    n = 0
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target in _UNCOUNTED:
            continue
        if node.target is torch.ops.aten.unsqueeze.default and all(
                u.target in _MATMULS for u in node.users):
            continue    # matmul's own reshape of a vector: none in jax
        vals = node.meta.get("val")
        for v in vals if isinstance(vals, (tuple, list)) else (vals,):
            if torch.is_tensor(v) and nt in tuple(v.shape):
                n += 1 + _lax_extra(node, v, nt)
    return max(n, 1)


# torch ops that have no jaxpr equation: the copy a constant's entry makes,
# and matmul's in-place squeeze of its own product
_UNCOUNTED = {torch.ops.aten.lift_fresh_copy.default,
              torch.ops.aten.squeeze_.dim}
_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default}
# elementwise ops whose operands jnp brings to one rank first
_RANK_PROMOTING = {"add", "sub", "rsub", "mul", "div", "pow", "maximum",
                   "minimum", "atan2", "where", "eq", "ne", "lt", "le",
                   "gt", "ge", "logical_and", "logical_or", "logical_xor",
                   "floor_divide", "clamp", "clamp_min", "clamp_max"}


def _lax_extra(node, v, nt):
    """The equations with time-shaped outputs that jax writes for an aten
    node beside its own: stack's expand_dims of each operand; mean's
    division after its sum; an elementwise op's expand_dims of an operand
    of lower rank that carries time."""
    if not isinstance(node.target, torch._ops.OpOverload):
        return 0
    name = node.target._schema.name.split("::")[-1]
    if name == "stack":
        return len(node.args[0])
    if name == "mean":
        return 1
    if name in _RANK_PROMOTING:
        return sum(1 for a in node.args if hasattr(a, "meta")
                   and torch.is_tensor(a.meta.get("val"))
                   and nt in tuple(a.meta["val"].shape)
                   and a.meta["val"].dim() < v.dim())
    return 0


def derive_time_signal_functor(model, nparams):
    """A TimeLocalEval (fn None) generated from ``model.time_signal``
    traced with P scalar parameter planes and a scalar t, or None."""

    def fn(*a):
        return model.time_signal(list(a[:nparams]), a[nparams])

    args = [torch.zeros(1, 1) for _ in range(nparams + 1)]
    try:
        gm = _trace(fn, args)
        gen = _Gen(gm, nparams, 0, None)
        gen.bind_inputs([f"m{i}" for i in range(nparams)] + ["t"],
                        [(1, 1)] * (nparams + 1))
        out = gen.run()
        gen.finish(out, None)
    except Exception:
        return None
    return TimeLocalEval(None, nparams, 0, gen.source(), gen.value_ops,
                         gen.tangent_ops)


def _trace(fn, args):
    """fn's aten graph: its arguments as fake tensors, the real tensors
    it closes over as constants (get_attr nodes)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(fn, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*args)


# -- the symbolic walk ---------------------------------------------------

class _Sym:
    """A traced tensor: its elements as C++ expressions (an object array
    over the non-time axes), the position of the time axis in the full
    shape (None: no time axis) and the full shape."""

    def __init__(self, elems, tdim, shape):
        self.elems = elems
        self.tdim = tdim
        self.shape = tuple(shape)


def _lit(x):
    if isinstance(x, bool):
        return "true" if x else "false"
    x = float(x)
    if not math.isfinite(x):
        raise Rejected("non-finite constant")
    return f"R({x!r})"


# the most elements a per-sample walk's constant may have: each is a literal
# of the generated source
_MAX_LITERALS = 4096

# elementwise ops: aten name -> (C++ function, value ops, tangent ops
# per component); the tangent rules are torch's forward-mode formulas
# away from kinks and jax's at them (csrc/dual.cuh)
_UNARY = {
    "exp": ("g_exp", 1, 1), "log": ("g_log", 1, 1),
    "log1p": ("g_log1p", 1, 2), "expm1": ("g_expm1", 1, 2),
    "sqrt": ("g_sqrt", 1, 2), "rsqrt": ("g_rsqrt", 1, 4),
    "sin": ("g_sin", 1, 2), "cos": ("g_cos", 1, 3), "tan": ("g_tan", 1, 3),
    "asin": ("g_asin", 1, 5), "acos": ("g_acos", 1, 5),
    "atan": ("g_atan", 1, 3), "sinh": ("g_sinh", 1, 2),
    "cosh": ("g_cosh", 1, 2), "tanh": ("g_tanh", 1, 3),
    "asinh": ("g_asinh", 1, 4), "acosh": ("g_acosh", 1, 5),
    "atanh": ("g_atanh", 1, 3), "erf": ("g_erf", 1, 5),
    "erfc": ("g_erfc", 1, 5), "sigmoid": ("g_sigmoid", 1, 3),
    "abs": ("g_abs", 1, 1), "reciprocal": ("g_reciprocal", 1, 3),
    "neg": ("-", 1, 1),
}
# value-only ops: no tangent (a zero derivative almost everywhere)
_FLAT = {"sign": "g_sign", "floor": "g_floor", "ceil": "g_ceil",
         "round": "g_round", "trunc": "g_trunc"}
_COMPARE = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
            "ge": ">="}
_LOGIC = {"logical_and": "&&", "logical_or": "||", "logical_xor": "!="}
_IDENTITY = {"clone", "alias", "detach", "lift_fresh_copy", "contiguous",
             "_to_copy"}
_FACTORIES = {"ones", "zeros", "full", "ones_like", "zeros_like",
              "full_like", "scalar_tensor", "new_ones", "new_zeros",
              "new_full"}


class _Gen:
    def __init__(self, gm, nparams, nsupp, nt):
        self.gm = gm
        self.p = nparams
        self.nsupp = nsupp
        self.nt = nt
        self.lines = []
        self.kind = {}      # expression -> 'R', 'S' or 'B'
        self.cse = {}       # emitted expression -> its name
        self.value_ops = 0
        self.tangent_ops = 0
        self.env = {}
        self.out_expr = None

    # -- bookkeeping --------------------------------------------------
    def kind_of(self, e):
        if e.startswith("R(") or e == "t":
            return "R"
        if e in ("true", "false"):
            return "B"
        return self.kind[e]

    def emit(self, kind, form, *uses, vops=0, tops=0):
        """The name of a line computing form(*uses): form makes the
        expression from the elements it reads, uses. The lines are pure:
        an expression emitted before is reused (so a time-free tensor of
        equal elements stays uniform)."""
        expr = form(*uses)
        if expr in self.cse:
            return self.cse[expr]
        name = f"v{len(self.kind)}"
        self.cse[expr] = name
        ctype = {"R": "R", "S": "S", "B": "bool"}[kind]
        self.lines.append(f"    const {ctype} {name} = {expr};")
        self.kind[name] = kind
        self.value_ops += vops
        if kind == "S":
            self.tangent_ops += tops * self.p
        return name

    def bind_inputs(self, names, shapes):
        placeholders = [n for n in self.gm.graph.nodes
                        if n.op == "placeholder"]
        for node, name, shape in zip(placeholders, names, shapes):
            if name == "m":
                el = np.array([f"m[{i}]" for i in range(shape[0])], object)
                for e in el:
                    self.kind[e] = "S"
            elif name == "supp":
                el = np.array([f"supp[{i}]" for i in range(shape[0])],
                              object)
                for e in el:
                    self.kind[e] = "R"
            elif name == "t":
                el = np.array([["t"]], object)
            else:                            # m<i>: a scalar plane
                el = np.array([[f"m[{name[1:]}]"]], object)
                self.kind[el[0, 0]] = "S"
            self.env[node] = _Sym(el, None, shape)

    def run(self):
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "get_attr":
                val = getattr(self.gm, node.target)
                self.env[node] = self.constant(val)
            elif node.op == "call_function":
                self.env[node] = self.call(node)
            elif node.op == "output":
                out = node.args[0]
                if isinstance(out, (tuple, list)):
                    if len(out) != 1:
                        raise Rejected("one output expected")
                    out = out[0]
                out = self.env[out]
            else:
                raise Rejected(f"node {node.op}")
        return out

    def constant(self, val):
        if not torch.is_tensor(val):
            raise Rejected("constant")
        return self.const_sym(val.detach().cpu().numpy())

    def const_sym(self, conc):
        """A constant (its values conc, numpy): its elements literals,
        its values kept beside them for the ops that fold it."""
        if conc.size > _MAX_LITERALS:
            raise Rejected("constant")
        el = np.vectorize(_lit, otypes=[object])(
            conc if conc.dtype == np.bool_ else conc.astype(np.float64)) \
            if conc.size else np.empty(conc.shape, object)
        sym = _Sym(np.asarray(el, object).reshape(conc.shape), None,
                   conc.shape)
        sym.conc = conc
        return sym

    def finish(self, out, want):
        """Check the output's shape and time axis; record its element."""
        if want is None:        # time_signal: one element
            if out.elems.size != 1 or out.tdim is not None:
                raise Rejected("time_signal output")
            e = out.elems.reshape(-1)[0]
        else:
            if out.shape != want:
                raise Rejected(f"output shape {out.shape}")
            if out.tdim == 0:
                e = out.elems.reshape(-1)[0]
            else:
                # a time-free [nt] output is time-local only if uniform
                el = out.elems.reshape(-1)
                if len(set(el)) != 1:
                    raise Rejected("output not indexed by time")
                e = el[0]
        if self.kind_of(e) == "B":
            raise Rejected("boolean output")
        self.out_expr = e

    def source(self):
        e = self.out_expr
        ret = e if self.kind_of(e) == "S" else f"g_lift<S>({e})"
        body = "\n".join(self.lines)
        return f"""struct GenModel {{
  static constexpr int P = {self.p};
  static constexpr int NS = {self.nsupp};

  // the model at one sample: S the parameters' scalar type (a dual
  // number for the Jacobian), R the real type
  template <class S, class R>
  __host__ __device__ static S signal(const S* m, const R* supp, R t) {{
    (void)supp;
    (void)t;
{body}
    return {ret};
  }}

  // signal and model-space Jacobian (csrc/vb_device.cuh's functor
  // contract); dt is the model's own, baked into the source
  __host__ __device__ static float eval(const float* m, const float* supp,
                                        float t, float /*dt*/,
                                        float* jac) {{
    return fabber::gen::eval_dual<GenModel, P>(m, supp, t, jac);
  }}
}};
"""

    # -- broadcasting ---------------------------------------------------
    def operand(self, x):
        if isinstance(x, _Sym):
            return x
        if isinstance(x, (bool, int, float)):
            return _Sym(np.array(_lit(x), object), None, ())
        raise Rejected(f"operand {type(x).__name__}")

    def broadcast(self, ops):
        """The operands' element arrays broadcast to the output shape
        (time axis removed), the output's time position and shape."""
        shapes = [o.shape for o in ops]
        try:
            out_shape = tuple(np.broadcast_shapes(*shapes))
        except ValueError:
            raise Rejected("broadcast")
        rank = len(out_shape)
        tpos = {o.tdim + rank - len(o.shape) for o in ops
                if o.tdim is not None}
        if len(tpos) > 1:
            raise Rejected("time axes misaligned")
        tdim = tpos.pop() if tpos else None
        out_nt = out_shape if tdim is None \
            else out_shape[:tdim] + out_shape[tdim + 1:]
        arrays = []
        for o in ops:
            el = o.elems.reshape((1,) * (rank - len(o.shape))
                                 + o.elems.shape)
            if o.tdim is None and tdim is not None:
                el = self.drop_uniform(el, tdim)
            arrays.append(np.broadcast_to(el, out_nt))
        return arrays, tdim, out_shape

    @staticmethod
    def drop_uniform(el, axis):
        """Remove a time-free axis where the time axis sits: of size 1,
        or of size nt with the same element all along it."""
        if el.shape[axis] != 1:
            first = np.take(el, [0], axis=axis)
            if not (el == first).all():
                raise Rejected("time-free axis varies along time")
        return np.take(el, 0, axis=axis)

    def elementwise(self, ops, fn):
        ops = [self.operand(o) for o in ops]
        arrays, tdim, shape = self.broadcast(ops)
        out = np.empty(arrays[0].shape, object)
        for idx in np.ndindex(out.shape):
            out[idx] = fn(*[a[idx] for a in arrays])
        return _Sym(out, tdim, shape)

    # -- scalar emitters -------------------------------------------------
    def kinds(self, *es):
        return [self.kind_of(e) for e in es]

    def arith(self, op, a, b):
        ka, kb = self.kinds(a, b)
        if "B" in (ka, kb):
            a, b = (self.to_real(x) for x in (a, b))
            ka, kb = self.kinds(a, b)
        kind = "S" if "S" in (ka, kb) else "R"
        both = ka == kb == "S"
        tops = {"+": 1, "-": 1, "*": 3 if both else 1,
                "/": 4 if both else (1 if ka == "S" else 3)}[op]
        return self.emit(kind, lambda x, y: f"{x} {op} {y}", a, b, vops=1,
                         tops=tops)

    def to_real(self, e):
        if self.kind_of(e) != "B":
            return e
        return self.emit("R", lambda x: f"({x} ? R(1.0) : R(0.0))", e)

    def unary(self, name, a):
        a = self.to_real(a)
        fn, vops, tops = _UNARY[name]
        kind = self.kind_of(a)
        if fn == "-":
            return self.emit(kind, lambda x: f"-{x}", a, vops=vops,
                             tops=tops)
        return self.emit(kind, lambda x: f"{fn}({x})", a, vops=vops,
                         tops=tops)

    def flat(self, name, a):
        a = self.to_real(a)
        return self.emit("R", lambda x: f"{_FLAT[name]}(g_val({x}))", a,
                         vops=1)

    def rounding_div(self, mode, a, b):
        """torch's division with rounding_mode floor or trunc
        (csrc/dual.cuh g_floordiv, g_truncdiv): a real, its derivative
        zero."""
        fn = {"floor": "g_floordiv", "trunc": "g_truncdiv"}.get(mode)
        if fn is None:
            raise Rejected(f"rounding mode {mode}")
        a, b = self.to_real(a), self.to_real(b)
        return self.emit("R", lambda x, y: f"{fn}(g_val({x}), g_val({y}))",
                         a, b, vops=2)

    def compare(self, op, a, b):
        a, b = self.to_real(a), self.to_real(b)
        return self.emit("B", lambda x, y: f"g_val({x}) {op} g_val({y})",
                         a, b, vops=1)

    def logic(self, op, a, b):
        if self.kinds(a, b) != ["B", "B"]:
            raise Rejected("logic on non-booleans")
        return self.emit("B", lambda x, y: f"{x} {op} {y}", a, b, vops=1)

    def binfn(self, fn, a, b, tops):
        a, b = self.to_real(a), self.to_real(b)
        kind = "S" if "S" in self.kinds(a, b) else "R"
        return self.emit(kind, lambda x, y: f"{fn}({x}, {y})", a, b,
                         vops=1, tops=tops)

    def pow_(self, a, b):
        a, b = self.to_real(a), self.to_real(b)
        ka, kb = self.kinds(a, b)
        kind = "S" if "S" in (ka, kb) else "R"
        if kb == "R" and b.startswith("R("):
            return self.emit(kind, lambda x, y: f"g_powc({x}, {y})", a, b,
                             vops=1, tops=3)
        return self.emit(kind, lambda x, y: f"g_pow({x}, {y})", a, b,
                         vops=1, tops=8)

    def where(self, c, a, b):
        if self.kind_of(c) != "B":
            raise Rejected("where condition")
        a, b = self.to_real(a), self.to_real(b)
        kind = "S" if "S" in self.kinds(a, b) else "R"
        return self.emit(kind, lambda w, x, y: f"g_where({w}, {x}, {y})",
                         c, a, b, vops=1, tops=1)

    def clamp(self, x, lo, hi):
        x = self.to_real(x)
        for bnd in (lo, hi):
            if bnd is not None and self.kind_of(bnd) == "S":
                raise Rejected("clamp bound depends on the parameters")
        lo = "R(-INFINITY)" if lo is None else lo
        hi = "R(INFINITY)" if hi is None else hi
        # csrc/dual.cuh: a max then a min, jax's clip
        return self.emit(self.kind_of(x),
                         lambda y, l, h: f"g_clamp({y}, {l}, {h})", x, lo,
                         hi, vops=2, tops=6)

    def extremum(self, is_max, items):
        """amax/amin of the elements: pairwise on reals; with a
        parameter-dependent element, one g_extremum over all of them
        (csrc/dual.cuh: the tangent shared evenly among ties, as jax's
        and torch's rules share it, which a pairwise fold would not)."""
        items = [self.to_real(e) for e in items]
        if len(items) == 1:
            return items[0]
        if "S" not in self.kinds(*items):
            fn = "g_max" if is_max else "g_min"
            acc = items[0]
            for e in items[1:]:
                acc = self.binfn(fn, acc, e, 3)
            return acc
        lifted = [e if self.kind_of(e) == "S" else
                  self.emit("S", lambda x: f"g_lift<S>({x})", e)
                  for e in items]
        flag = "true" if is_max else "false"
        return self.emit("S", lambda *xs: f"g_extremum<{flag}>("
                         f"{', '.join(xs)})", *lifted,
                         vops=len(items) - 1, tops=len(items) + 1)

    # -- reductions over non-time axes ------------------------------------
    def reduce(self, x, dims, keepdim, combine, combine_all=None):
        if dims is None or len(dims) == 0:
            dims = list(range(len(x.shape)))
        dims = sorted(d % max(len(x.shape), 1) for d in dims)
        if x.tdim is not None and x.tdim in dims:
            raise Rejected("reduction along time")
        eaxes = [self.eaxis(x, d) for d in dims]
        el = np.moveaxis(x.elems, eaxes, list(range(-len(eaxes), 0))) \
            if eaxes else x.elems
        lead = el.shape[:el.ndim - len(eaxes)]
        flat = el.reshape(lead + (-1,))
        out = np.empty(lead, object)
        for idx in np.ndindex(lead):
            items = list(flat[idx])
            if combine_all is not None:
                out[idx] = combine_all(items)
                continue
            acc = items[0]
            for it in items[1:]:
                acc = combine(acc, it)
            out[idx] = acc
        shape = list(x.shape)
        tdim = x.tdim
        for d in reversed(dims):
            if keepdim:
                shape[d] = 1
            else:
                del shape[d]
                if tdim is not None and d < tdim:
                    tdim -= 1
        if keepdim:
            for ax in sorted(eaxes):
                out = np.expand_dims(out, ax)
        return _Sym(out, tdim, shape)

    @staticmethod
    def eaxis(x, d):
        """The element-array axis of full-shape axis d (not the time
        axis)."""
        return d if x.tdim is None or d < x.tdim else d - 1

    # -- the node dispatcher ------------------------------------------------
    def arg(self, a):
        if hasattr(a, "op") and a in self.env:
            return self.env[a]
        if isinstance(a, (list, tuple)):
            return [self.arg(x) for x in a]
        return a

    def call(self, node):
        """Ops whose tensor operands all have values (constants, and the
        sample index, arange(nt)) are computed here too, on those values
        (torch on the CPU): a result without a time axis (no axis of nt
        samples) is a constant (const_sym); one with a time axis keeps its
        per-sample lines and its values beside them, and where the walk
        has no lines for it, const_time's."""
        args = [self.arg(a) for a in node.args]
        kw = {k: self.arg(v) for k, v in node.kwargs.items()}
        syms = [x for x in _flat(args) + _flat(list(kw.values()))
                if isinstance(x, _Sym)]
        if not syms or any(getattr(x, "conc", None) is None for x in syms):
            return self.dispatch(node, args, kw)

        def real(x):
            if isinstance(x, _Sym):
                return torch.as_tensor(x.conc)
            if isinstance(x, (list, tuple)):
                return type(x)(real(y) for y in x)
            return x
        out = node.target(*real(args), **{k: real(v) for k, v in kw.items()})
        if not torch.is_tensor(out) or out.dtype.is_complex:
            raise Rejected(f"constant {node.target}")
        conc = out.detach().numpy()
        if all(x.tdim is None for x in syms) or self.nt not in conc.shape:
            return self.const_sym(conc)
        try:
            sym = self.dispatch(node, args, kw)
        except Rejected:
            return self.const_time(conc)
        if sym.tdim is None:
            return self.const_sym(conc)
        sym.conc = conc
        return sym

    def const_time(self, conc):
        """A constant with a time axis that no per-sample line computes: a
        per-sample functor cannot read it (it has no constant buffer)."""
        raise Rejected("a constant that varies along time")

    def dispatch(self, node, args, kw):
        target = node.target
        if target is operator.getitem and isinstance(args[0], list):
            return args[0][args[1]]     # an element of unbind's list
        if not isinstance(target, torch._ops.OpOverload):
            raise Rejected(f"call {target}")
        if target.namespace != "aten":
            raise Rejected(f"custom op {target}")
        name = target._schema.name.split("::")[-1]
        val = node.meta.get("val")
        if torch.is_tensor(val) and (val.dtype.is_complex
                                     or val.dtype == torch.float64):
            raise Rejected(f"{name} computes in {val.dtype}")
        h = getattr(self, f"op_{name}", None)
        if h is not None:
            return h(node, args, kw, val)
        if name in _UNARY:
            return self.elementwise([args[0]],
                                    lambda a: self.unary(name, a))
        if name in _FLAT:
            return self.elementwise([args[0]], lambda a: self.flat(name, a))
        base = name.rstrip("_")
        if base in _COMPARE:
            return self.elementwise(
                args[:2], lambda a, b: self.compare(_COMPARE[base], a, b))
        if name in _LOGIC:
            return self.elementwise(
                args[:2], lambda a, b: self.logic(_LOGIC[name], a, b))
        if name in _IDENTITY:
            return self.cast(node, args[0], val)
        if name in _FACTORIES:
            return self.factory(name, args, kw, val)
        raise Rejected(f"op {name}")

    def cast(self, node, x, val):
        """A copy or a dtype cast: to a float type the elements become
        reals, to bool a test against 0; a float cast to an integer type
        (a truncation) is refused."""
        if not torch.is_tensor(val):
            return x
        if val.dtype.is_floating_point:
            return self.elementwise([x], self.to_real)
        if val.dtype == torch.bool:
            return self.elementwise([x], lambda e: e if self.kind_of(e)
                                    == "B" else self.emit(
                                        "B", lambda y: f"g_val({y}) != R(0.0)",
                                        e, vops=1))
        src = node.args[0].meta.get("val")
        if torch.is_tensor(src) and src.dtype.is_floating_point:
            raise Rejected("cast to an integer type")
        return x

    # arithmetic
    def op_add(self, node, a, kw, val):
        alpha = kw.get("alpha", a[2] if len(a) > 2 else 1)
        y = a[1]
        if alpha != 1:
            y = self.elementwise([y, alpha],
                                 lambda p, q: self.arith("*", p, q))
        return self.elementwise([a[0], y],
                                lambda p, q: self.arith("+", p, q))

    def op_sub(self, node, a, kw, val):
        alpha = kw.get("alpha", a[2] if len(a) > 2 else 1)
        y = a[1]
        if alpha != 1:
            y = self.elementwise([y, alpha],
                                 lambda p, q: self.arith("*", p, q))
        return self.elementwise([a[0], y],
                                lambda p, q: self.arith("-", p, q))

    def op_rsub(self, node, a, kw, val):
        return self.op_sub(node, [a[1], a[0]] + a[2:], kw, val)

    def op_mul(self, node, a, kw, val):
        return self.elementwise(a[:2], lambda p, q: self.arith("*", p, q))

    def op_div(self, node, a, kw, val):
        mode = kw.get("rounding_mode", a[2] if len(a) > 2 else None)
        if mode is not None:
            return self.elementwise(
                a[:2], lambda p, q: self.rounding_div(mode, p, q))
        return self.elementwise(a[:2], lambda p, q: self.arith("/", p, q))

    def op_floor_divide(self, node, a, kw, val):
        return self.elementwise(
            a[:2], lambda p, q: self.rounding_div("floor", p, q))

    def op_pow(self, node, a, kw, val):
        return self.elementwise(a[:2], self.pow_)

    def op_square(self, node, a, kw, val):
        return self.elementwise([a[0], 2], self.pow_)

    def op_maximum(self, node, a, kw, val):
        return self.elementwise(
            a[:2], lambda p, q: self.binfn("g_max", p, q, 3))

    def op_minimum(self, node, a, kw, val):
        return self.elementwise(
            a[:2], lambda p, q: self.binfn("g_min", p, q, 3))

    def op_atan2(self, node, a, kw, val):
        return self.elementwise(
            a[:2], lambda p, q: self.binfn("g_atan2", p, q, 6))

    def op_clamp(self, node, a, kw, val):
        lo = kw.get("min", a[1] if len(a) > 1 else None)
        hi = kw.get("max", a[2] if len(a) > 2 else None)
        ops = [a[0]] + [x for x in (lo, hi) if x is not None]

        def f(x, *bnd):
            it = iter(bnd)
            return self.clamp(x, next(it) if lo is not None else None,
                              next(it) if hi is not None else None)
        return self.elementwise(ops, f)

    def op_clamp_min(self, node, a, kw, val):
        return self.elementwise(a[:2], lambda x, b: self.clamp(x, b, None))

    def op_clamp_max(self, node, a, kw, val):
        return self.elementwise(a[:2], lambda x, b: self.clamp(x, None, b))

    def op_where(self, node, a, kw, val):
        return self.elementwise(a[:3], self.where)

    def op_logical_not(self, node, a, kw, val):
        def f(x):
            if self.kind_of(x) != "B":
                x = self.emit("B", lambda y: f"g_val({y}) != R(0.0)", x,
                              vops=1)
            return self.emit("B", lambda y: f"!{y}", x, vops=1)
        return self.elementwise([a[0]], f)

    # the time axis and constants
    def op_arange(self, node, a, kw, val):
        """arange(nt) is the sample index t (a time axis); any other
        length a constant. Either keeps its values."""
        n = int(val.shape[0])
        if len(a) == 1:
            start, step = 0, 1
        else:
            start, step = a[0], a[2] if len(a) > 2 else 1
        conc = (np.arange(n, dtype=np.float64) * float(step)
                + float(start)).astype(torch.empty(0, dtype=val.dtype)
                                       .numpy().dtype)
        if self.nt is None or n != self.nt:
            return self.const_sym(conc)
        if (start, step) == (0, 1):
            x = _Sym(np.array("t", object), 0, (n,))
        else:
            e = self.emit("R", lambda t: f"R({float(start)!r} + "
                          f"{float(step)!r} * (double){t})", "t")
            x = _Sym(np.array(e, object), 0, (n,))
        x.conc = conc
        return x

    def factory(self, name, a, kw, val):
        fill = {"ones": 1.0, "zeros": 0.0, "ones_like": 1.0,
                "zeros_like": 0.0, "new_ones": 1.0, "new_zeros": 0.0}.get(name)
        if fill is None:
            fill = a[0] if name == "scalar_tensor" else a[-1]
        if isinstance(fill, _Sym):
            raise Rejected("fill from a tensor")
        shape = tuple(val.shape)
        if val.dtype == torch.bool:
            e = _lit(bool(fill))
        else:
            e = _lit(fill)
        return _Sym(np.full(shape, e, object), None, shape)

    # shape ops
    def op_select(self, node, a, kw, val):
        x, dim, idx = a[0], a[1] % len(a[0].shape), a[2]
        if dim == x.tdim:
            raise Rejected("select along time")
        ax = self.eaxis(x, dim)
        el = np.take(x.elems, idx % x.shape[dim], axis=ax)
        tdim = x.tdim if x.tdim is None or dim > x.tdim else x.tdim - 1
        shape = x.shape[:dim] + x.shape[dim + 1:]
        return _Sym(np.asarray(el, object), tdim, shape)

    def op_unbind(self, node, a, kw, val):
        x = a[0]
        dim = (a[1] if len(a) > 1 else kw.get("dim", 0)) % len(x.shape)
        return [self.op_select(node, [x, dim, i], {}, None)
                for i in range(x.shape[dim])]

    def op_slice(self, node, a, kw, val):
        x = a[0]
        dim = (a[1] if len(a) > 1 else 0) % len(x.shape)
        start = a[2] if len(a) > 2 and a[2] is not None else 0
        end = a[3] if len(a) > 3 and a[3] is not None else x.shape[dim]
        step = a[4] if len(a) > 4 else 1
        rng = range(*slice(start, end, step).indices(x.shape[dim]))
        if dim == x.tdim:
            if list(rng) == list(range(x.shape[dim])):
                return x
            raise Rejected("slice along time")
        ax = self.eaxis(x, dim)
        el = np.take(x.elems, list(rng), axis=ax)
        shape = list(x.shape)
        shape[dim] = len(rng)
        return _Sym(np.asarray(el, object), x.tdim, shape)

    def op_unsqueeze(self, node, a, kw, val):
        x = a[0]
        dim = a[1] % (len(x.shape) + 1)
        tdim = x.tdim
        if tdim is not None and dim <= tdim:
            tdim += 1
        shape = x.shape[:dim] + (1,) + x.shape[dim:]
        return _Sym(np.expand_dims(x.elems, self.eaxis(
            _Sym(None, tdim, shape), dim)), tdim, shape)

    def op_squeeze(self, node, a, kw, val):
        x = a[0]
        if len(a) > 1:
            dims = a[1] if isinstance(a[1], (list, tuple)) else [a[1]]
            dims = [d % max(len(x.shape), 1) for d in dims]
        else:
            dims = list(range(len(x.shape)))
        dims = [d for d in dims if x.shape[d] == 1 and d != x.tdim]
        return self.reshape(x, tuple(s for d, s in enumerate(x.shape)
                                     if d not in dims))

    # matmul's in-place forms of its own intermediates
    op_squeeze_ = op_squeeze

    def op_view(self, node, a, kw, val):
        return self.reshape(a[0], tuple(val.shape))

    op_reshape = op_view
    op__unsafe_view = op_view

    def reshape(self, x, shape):
        if x.tdim is None:
            return _Sym(x.elems.reshape(shape), None, shape)
        # a time tensor may only gain or lose size-1 axes
        if [s for s in x.shape if s != 1] != [s for s in shape if s != 1]:
            raise Rejected("reshape mixes the time axis")
        k = sum(1 for s in x.shape[:x.tdim] if s != 1)
        tdim = [d for d, s in enumerate(shape) if s != 1][k]
        return _Sym(x.elems.reshape(shape[:tdim] + shape[tdim + 1:]), tdim,
                    shape)

    def op_expand(self, node, a, kw, val):
        x, sizes = a[0], list(val.shape)
        off = len(sizes) - len(x.shape)
        tdim = None if x.tdim is None else x.tdim + off
        if tdim is not None and sizes[tdim] != x.shape[x.tdim]:
            raise Rejected("expand along time")
        el = x.elems.reshape((1,) * off + x.elems.shape)
        el_shape = sizes if tdim is None else sizes[:tdim] + sizes[tdim + 1:]
        return _Sym(np.broadcast_to(el, el_shape).copy(), tdim, sizes)

    def op_permute(self, node, a, kw, val):
        x, perm = a[0], [d % len(a[0].shape) for d in a[1]]
        shape = tuple(x.shape[d] for d in perm)
        if x.tdim is None:
            return _Sym(np.transpose(x.elems, perm), None, shape)
        tdim = perm.index(x.tdim)
        eperm = [self.eaxis(x, d) for d in perm if d != x.tdim]
        return _Sym(np.transpose(x.elems, eperm), tdim, shape)

    def op_transpose(self, node, a, kw, val):
        n = len(a[0].shape)
        perm = list(range(n))
        i, j = a[1] % n, a[2] % n
        perm[i], perm[j] = perm[j], perm[i]
        return self.op_permute(node, [a[0], perm], kw, val)

    def op_t(self, node, a, kw, val):
        n = len(a[0].shape)
        return self.op_permute(node, [a[0], list(range(n))[::-1]], kw, val)

    def op_cat(self, node, a, kw, val):
        xs = [x for x in a[0] if x.shape != (0,)]
        dim = (a[1] if len(a) > 1 else kw.get("dim", 0)) % len(val.shape)
        return self.join(xs, dim, tuple(val.shape), stack=False)

    def op_stack(self, node, a, kw, val):
        dim = (a[1] if len(a) > 1 else kw.get("dim", 0)) % len(val.shape)
        xs = [self.op_unsqueeze(node, [x, dim], kw, None) for x in a[0]]
        return self.join(xs, dim, tuple(val.shape), stack=True)

    def join(self, xs, dim, shape, stack):
        tds = {x.tdim for x in xs if x.tdim is not None}
        if len(tds) > 1:
            raise Rejected("joined time axes misaligned")
        tdim = tds.pop() if tds else None
        if tdim == dim:
            raise Rejected("concatenation along time")
        parts = []
        for x in xs:
            el = x.elems
            if tdim is not None and x.tdim is None:
                el = self.drop_uniform(el, tdim)
            parts.append(el)
        ax = dim if tdim is None or dim < tdim else dim - 1
        return _Sym(np.concatenate(parts, axis=ax), tdim, shape)

    # reductions
    def red_args(self, a, kw):
        dims = a[1] if len(a) > 1 else kw.get("dim")
        if isinstance(dims, int):
            dims = [dims]
        keep = a[2] if len(a) > 2 else kw.get("keepdim", False)
        return dims, keep

    def op_sum(self, node, a, kw, val):
        dims, keep = self.red_args(a, kw)
        return self.reduce(a[0], dims, keep,
                           lambda p, q: self.arith("+", p, q))

    def op_mean(self, node, a, kw, val):
        dims, keep = self.red_args(a, kw)
        x = a[0]
        dl = dims or list(range(len(x.shape)))
        n = int(np.prod([x.shape[d] for d in dl]))
        s = self.reduce(x, dims, keep, lambda p, q: self.arith("+", p, q))
        return self.elementwise([s, n], lambda p, q: self.arith("/", p, q))

    def op_prod(self, node, a, kw, val):
        dims, keep = self.red_args(a, kw)
        return self.reduce(a[0], dims, keep,
                           lambda p, q: self.arith("*", p, q))

    def op_amax(self, node, a, kw, val):
        dims, keep = self.red_args(a, kw)
        return self.reduce(a[0], dims, keep, None,
                           lambda items: self.extremum(True, items))

    def op_amin(self, node, a, kw, val):
        dims, keep = self.red_args(a, kw)
        return self.reduce(a[0], dims, keep, None,
                           lambda items: self.extremum(False, items))

    def op_max(self, node, a, kw, val):
        """max() of all elements (reduce_max); max(x, y) elementwise.
        max(x, dim), with its indices, is refused."""
        if len(a) == 2 and isinstance(a[1], _Sym):
            return self.op_maximum(node, a, kw, val)
        if len(a) > 1 or kw:
            raise Rejected("max with indices")
        return self.op_amax(node, a[:1], {}, val)

    def op_min(self, node, a, kw, val):
        if len(a) == 2 and isinstance(a[1], _Sym):
            return self.op_minimum(node, a, kw, val)
        if len(a) > 1 or kw:
            raise Rejected("min with indices")
        return self.op_amin(node, a[:1], {}, val)

    # -- contractions -----------------------------------------------------
    def op_dot(self, node, a, kw, val):
        x, y = a[0], a[1]
        z = self.contract(self.reshape(x, (1,) + x.shape),
                          self.reshape(y, y.shape + (1,)))
        return self.reshape(z, ())

    def op_mv(self, node, a, kw, val):
        y = self.contract(a[0], self.reshape(a[1], a[1].shape + (1,)))
        return self.reshape(y, y.shape[:1])

    def op_mm(self, node, a, kw, val):
        return self.contract(a[0], a[1])

    def op_addmm(self, node, a, kw, val):
        """input + mat1 @ mat2 (nn.functional.linear's trace)."""
        if kw.get("beta", 1) != 1 or kw.get("alpha", 1) != 1:
            raise Rejected("addmm with beta or alpha")
        return self.elementwise([a[0], self.contract(a[1], a[2])],
                                lambda p, q: self.arith("+", p, q))

    def op_bmm(self, node, a, kw, val):
        x, y = a[0], a[1]
        if x.shape[0] != 1 or y.shape[0] != 1:
            raise Rejected("a batched contraction")
        z = self.contract(self.reshape(x, x.shape[1:]),
                          self.reshape(y, y.shape[1:]))
        return self.reshape(z, (1,) + z.shape)

    def contract(self, x, y):
        """x [I,K] @ y [K,J] over an axis that is not time, unrolled as
        the other non-time axes are: each output a sum over k of the
        products, k = 0 first (either operand may depend on the
        parameters). A time axis may be a free axis of one operand; a
        contraction along time is the full-time walk's."""
        (ni, nk), (nk2, nj) = x.shape, y.shape
        if nk != nk2:
            raise Rejected("contraction shapes")
        if x.tdim == 1 or y.tdim == 0:
            raise Rejected("a contraction along time")
        if x.tdim == 0 and y.tdim == 1:
            raise Rejected("time axes misaligned")
        rows = 1 if x.tdim == 0 else ni
        cols = 1 if y.tdim == 1 else nj
        if rows * cols * nk > _MAX_LITERALS:
            raise Rejected("a contraction too large to unroll")

        def xel(i, k):
            return x.elems[k] if x.tdim == 0 else x.elems[i, k]

        def yel(k, j):
            return y.elems[k] if y.tdim == 1 else y.elems[k, j]
        out = np.empty((rows, cols), object)
        for i in range(rows):
            for j in range(cols):
                acc = None
                for k in range(nk):
                    term = self.arith("*", self.to_real(xel(i, k)),
                                      self.to_real(yel(k, j)))
                    acc = term if acc is None else self.arith("+", acc, term)
                out[i, j] = acc
        if x.tdim == 0:
            return _Sym(out[0], 0, (ni, nj))
        if y.tdim == 1:
            return _Sym(out[:, 0], 1, (ni, nj))
        return _Sym(out, None, (ni, nj))


# -- the full-time walk ----------------------------------------------------

# an element of a constant in the functor's constant buffer
_CREF = re.compile(r"cst\[(\d+)\]")
# get_attr constants of at most this many elements stay literals
_LITERAL_CONST = 16


class _Seg:
    """A loop over the n samples of one time length, a sample a lane: its
    lines, and whether later time-local lines may still join it."""

    def __init__(self, idx, n):
        self.idx, self.n, self.lines, self.open = idx, n, [], True


class _Conc(_Sym):
    """A constant of the trace (a tensor the model closes over, and what
    is computed from constants alone) with its values; its elements are
    literals or reads of the functor's constant buffer, made at first
    use."""

    def __init__(self, gen, conc):
        self.gen, self.conc, self.tdim = gen, conc, None
        self.shape = tuple(conc.shape)
        self._el = None

    @property
    def elems(self):
        if self._el is None:
            self._el = self.gen.const_elems(self.conc)
        return self._el


class _PLeaf:
    """A value with two time axes, at a leaf: the time element e (of n
    samples) of an operand whose time axis is the pair's axis `axis` (0
    the first, 1 the second)."""

    def __init__(self, e, axis, n):
        self.e, self.axis, self.n = e, axis, n


class _PConst:
    """A constant that varies along both time axes: cst[off + i sa + j sb]
    at sample i of the first axis and j of the second."""

    def __init__(self, off, sa, sb):
        self.off, self.sa, self.sb = off, sa, sb


class _PNode:
    """A value with two time axes: fn (a scalar emitter) of its operands'
    nodes, leaves or time-free expressions."""

    def __init__(self, fn, kids):
        self.fn, self.kids = fn, kids


class _Pair(_Sym):
    """A traced tensor with two time axes (tdims, in the full shape): its
    elements (over the other axes) nodes, evaluated only inside the
    reduction that ends the pair (_FullGen.pair_reduce), where a lane owns
    a sample of the kept axis and a loop runs the other. vpos: the
    position of an axis of nt samples along which only a constant varies
    (a virtual time axis: s[:, None] * w[None, :]), or None; such a pair
    can still become one time axis of elements (_FullGen.realize)."""

    def __init__(self, elems, tdims, shape, vpos=None):
        super().__init__(elems, None, shape)
        self.tdims = tdims
        self.vpos = vpos


class _Inner:
    """The loop over the reduced time axis inside a lane's sample loop
    (seg): its lines, its names and the number of times each of its
    lines runs per evaluation."""

    def __init__(self, idx, seg, count):
        self.idx, self.seg, self.count = idx, seg, count
        self.lines, self.names = [], set()
        self.vops = self.tops = 0


# the ops a value with two time axes may reach: elementwise ones and
# reductions
_PAIR_OPS = (set(_UNARY) | set(_FLAT) | set(_COMPARE) | set(_LOGIC)
             | _IDENTITY | {"add", "sub", "rsub", "mul", "div", "pow",
                            "square", "maximum", "minimum", "atan2",
                            "clamp", "clamp_min", "clamp_max", "where",
                            "logical_not", "floor_divide", "sum", "mean",
                            "prod", "amax", "amin", "max", "min"})


class _FullGen(_Gen):
    """The full-time walk (module docstring): the per-sample walk's ops,
    and the time-mixing ops of the JAX allowlist. An element of a time
    tensor is the sample index t, a time-free expression (uniform along
    time), a name defined in a sample loop (_Seg) or a map (@mK: for each
    sample, where its value comes from). A value that a time-mixing op
    reads is stored in a shared-memory plane by the loop that computes it
    (materialize; width P + 1 for an S value, 1 for an R value), and that
    loop is closed (the warp's barrier follows it) before any read;
    reductions are lines outside the loops, each lane folding its slice
    of the plane and a butterfly across the lanes closing it
    (csrc/fulltime.cuh ft_close)."""

    def __init__(self, gm, nparams, nsupp, nt):
        super().__init__(gm, nparams, nsupp, nt)
        self.items = []        # function-scope lines and _Segs, in order
        self.seg_of = {}       # time-local name -> its _Seg
        self.planes = {}       # name -> (offset, length, kind)
        self.maps = {}         # @mK -> (kind, per-sample descriptors)
        self.cvals = []        # the constant buffer's blocks (float64)
        self.nconst = 0
        self.zero_ops = 0      # of the ops counted, products by known zeros
        self.sh_floats = 0
        self.active_n = None   # time length of the op being walked
        self.inner = None      # the open _Inner loop (pair_fold)
        self.n_inner = 0

    # -- bookkeeping --------------------------------------------------
    def kind_of(self, e):
        if e.startswith("@m"):
            return self.maps[e][0]
        if _CREF.fullmatch(e) or e in ("ti", "tj"):
            return "R"
        return super().kind_of(e)

    def _new_name(self, kind):
        name = f"v{len(self.kind)}"
        self.kind[name] = kind
        return name

    def _open_seg(self):
        last = self.items[-1] if self.items else None
        return last if isinstance(last, _Seg) and last.open else None

    def is_local(self, e):
        """e is a time-local element: the sample index (t as a real, ti
        the lane's integer sample), a map or a name defined in a sample
        loop."""
        return (e in ("t", "ti") or e.startswith("@m") or e in self.seg_of
                or self.is_inner(e))

    def is_inner(self, e):
        """e is a name of the open inner loop, or its sample tj."""
        return self.inner is not None and (e == "tj"
                                           or e in self.inner.names)

    def emit(self, kind, form, *uses, vops=0, tops=0):
        """As the per-sample walk's; a line that uses a time-local element
        goes into the open loop of the active time length, each such use
        made a name of that loop (localize), the others at function
        scope."""
        ctype = {"R": "R", "S": "S", "B": "bool"}[kind]
        inner = self.inner
        if inner is not None and any(self.is_inner(u) for u in uses):
            # a line of the inner loop: its lane-local uses names of the
            # lane's loop
            expr = form(*[u if self.is_inner(u) or not self.is_local(u)
                          else self.localize(u, inner.seg) for u in uses])
            if expr in inner.names:
                return expr
            key = ("inner", inner.idx, expr)
            if key in self.cse:
                return self.cse[key]
            name = self._new_name(kind)
            self.cse[key] = name
            inner.lines.append(f"    const {ctype} {name} = {expr};")
            inner.names.add(name)
            inner.vops += vops
            inner.tops += tops if kind == "S" else 0
            self.count(kind, vops, tops, inner.count)
            return name
        if not any(self.is_local(u) for u in uses):
            # time-free: at function scope, before an open loop
            expr = form(*uses)
            key = ("fs", expr)
            if key in self.cse:
                return self.cse[key]
            name = self._new_name(kind)
            self.cse[key] = name
            line = f"    const {ctype} {name} = {expr};"
            seg = self._open_seg()
            self.items.insert(len(self.items) - (seg is not None), line)
            self.count(kind, vops, tops, 1)
            return name
        n = self.active_n
        if n is None:
            raise Rejected("a time-local value of unknown length")
        seg = self.segment(n)
        expr = form(*[self.localize(u, seg) if self.is_local(u) else u
                      for u in uses])
        if self.seg_of.get(expr) is seg:   # a name of this loop already
            return expr
        key = (seg.idx, expr)
        if key in self.cse:
            return self.cse[key]
        name = self._new_name(kind)
        self.cse[key] = name
        seg.lines.append(f"    const {ctype} {name} = {expr};")
        self.seg_of[name] = seg
        self.count(kind, vops, tops, n)
        return name

    def count(self, kind, vops, tops, n):
        self.value_ops += vops * n
        if kind == "S":
            self.tangent_ops += tops * self.p * n

    def segment(self, n):
        """The open loop of n samples (a new one after closing an open
        loop of another length)."""
        seg = self._open_seg()
        if seg is not None and seg.n != n:
            seg.open = False
            seg = None
        if seg is None:
            seg = _Seg(sum(isinstance(x, _Seg) for x in self.items), n)
            self.items.append(seg)
        return seg

    def localize(self, e, seg):
        """Time-local element e as a name of the loop seg (sample ti)."""
        if e in ("t", "ti") or self.seg_of.get(e) is seg:
            return e
        if e.startswith("@m"):
            return self.map_expr(e, seg)
        off, n, kind = self.materialize(e)
        return self.emit(kind, lambda i: self.plane_read(kind, off, n, i),
                         "ti")

    def plane_read(self, kind, off, n, idx):
        if kind == "S":
            return f"ft_load<S>(sh + {off}, {n}, {idx})"
        return f"sh[{off} + {idx}]"

    def materialize(self, name):
        """The shared plane (offset, length, kind) that name's loop stores
        it into; its loop is closed, so later lines read it after the
        barrier."""
        if name not in self.planes:
            seg = self.seg_of[name]
            kind = self.kind[name]
            if kind == "B":
                raise Rejected("a boolean value across samples")
            off = self.sh_floats
            self.sh_floats += (self.p + 1 if kind == "S" else 1) * seg.n
            seg.lines.append(f"    ft_store(sh + {off}, {seg.n}, ti, {name});")
            self.planes[name] = (off, seg.n, kind)
        self.seg_of[name].open = False
        return self.planes[name]

    def local_name(self, e, n):
        """A name for time element e (of a time length n) in the open loop
        of n samples."""
        self.active_n = n
        seg = self.segment(n)
        if self.seg_of.get(e) is seg:
            return e
        if self.is_local(e):
            return self.emit(self.kind_of(e), lambda x: x, e)
        kind = self.kind_of(e)
        name = self._new_name(kind)
        ctype = {"R": "R", "S": "S"}.get(kind)
        if ctype is None:
            raise Rejected("a boolean value across samples")
        seg.lines.append(f"    const {ctype} {name} = {e};")
        self.seg_of[name] = seg
        return name

    def plane_of(self, e, n):
        """The plane of time element e (time length n): its own loop's
        where e is a name, else that of e made a name in the open loop."""
        return self.materialize(e if e in self.seg_of
                                else self.local_name(e, n))

    # -- maps of samples ---------------------------------------------------
    def desc(self, e, n, j):
        """Where sample j of time element e (time length n) comes from:
        ("i", j) the index, ("p", off, len, kind, j) a plane, ("c", k)
        the constant buffer, ("f", e) a time-free value."""
        if e == "t":
            return ("i", j)
        if e.startswith("@m"):
            return self.maps[e][1][j]
        if e in self.seg_of:
            off, ln, kind = self.materialize(e)
            return ("p", off, ln, kind, j)
        mo = _CREF.fullmatch(e)
        if mo:
            return ("c", int(mo.group(1)))
        return ("f", e)

    def new_map(self, descs):
        """A time element from its samples' descriptors: an @mK token, or
        the one time-free value they all are."""
        if not descs:
            raise Rejected("an empty time axis")
        if all(d[0] == "f" and d[1] == descs[0][1] for d in descs):
            return descs[0][1]
        kinds = set()
        for d in descs:
            k = {"i": "R", "c": "R", "p": None, "f": None}[d[0]]
            k = k or (d[3] if d[0] == "p" else self.kind_of(d[1]))
            if k == "B":
                raise Rejected("a boolean value across samples")
            kinds.add(k)
        tok = f"@m{len(self.maps)}"
        self.maps[tok] = ("S" if "S" in kinds else "R", descs)
        return tok

    @staticmethod
    def pieces(descs):
        """The descriptors grouped into runs [lo, hi) whose index is
        a + b * (sample - lo)."""
        out = []
        for j, d in enumerate(descs):
            key = d[:-1] if d[0] in ("i", "p", "c") else d
            idx = d[-1] if d[0] in ("i", "p", "c") else 0
            if out and out[-1][0] == key:
                pc = out[-1]
                if pc[4] is None or idx == pc[3] + pc[4] * (j - pc[1]):
                    pc[4] = idx - pc[3] if pc[4] is None else pc[4]
                    pc[2] = j + 1
                    continue
            out.append([key, j, j + 1, idx, None])
        return out

    def map_expr(self, tok, seg, idx="ti", n=None):
        """Map tok at the sample idx of a loop of n samples (seg's, the
        lane's, by default)."""
        kind, descs = self.maps[tok]
        if len(descs) != (seg.n if n is None else n):
            raise Rejected("a map of another time length")
        pieces = list(reversed(self.pieces(descs)))

        def form(ti):
            expr = None
            for key, lo, hi, a, b in pieces:
                b = b or 0
                idx = f"({a - b * lo} + {b} * {ti})"
                if key[0] == "i":
                    val = f"R{idx}"
                elif key[0] == "c":
                    val = f"cst[{idx}]"
                elif key[0] == "p":
                    _, off, n, pk = key
                    val = self.plane_read(pk, off, n, idx)
                    if pk == "R" and kind == "S":
                        val = f"g_lift<S>({val})"
                else:
                    val = key[1]
                    if self.kind_of(val) == "R" and kind == "S":
                        val = f"g_lift<S>({val})"
                if key[0] in ("i", "c") and kind == "S":
                    val = f"g_lift<S>({val})"
                expr = val if expr is None else \
                    f"({ti} < {hi} ? {val} : {expr})"
            return expr
        return self.emit(kind, form, idx)

    def drop_uniform(self, el, axis):
        """A time-free array along the time axis: uniform, or a map per
        element."""
        first = np.take(el, [0], axis=axis)
        if el.shape[axis] == 1 or (el == first).all():
            return np.take(el, 0, axis=axis)
        moved = np.moveaxis(el, axis, -1)
        out = np.empty(moved.shape[:-1], object)
        for idx in np.ndindex(out.shape):
            out[idx] = self.new_map([self.desc(e, len(moved[idx]), j)
                                     for j, e in enumerate(moved[idx])])
        return out

    # -- constants ----------------------------------------------------------
    def const_sym(self, conc):
        return _Conc(self, conc)

    def const_time(self, conc):
        """A constant with a time axis that no per-sample line computes (a
        [T,T] matrix built from the index): read from the constant
        buffer."""
        return _Conc(self, conc)

    def const_elems(self, conc):
        if conc.dtype == np.bool_ or conc.size <= _LITERAL_CONST:
            return np.vectorize(_lit, otypes=[object])(
                conc if conc.dtype == np.bool_ else conc.astype(np.float64)
            ).reshape(conc.shape) if conc.size else np.empty(conc.shape,
                                                              object)
        off = self.register(conc)
        return np.array([f"cst[{off + i}]" for i in range(conc.size)],
                        object).reshape(conc.shape)

    def register(self, values):
        off = self.nconst
        flat = np.asarray(values, np.float64).ravel()
        if not np.isfinite(flat).all():
            raise Rejected("non-finite constant")
        self.cvals.append(flat)
        self.nconst += flat.size
        return off

    def const_values(self):
        """The functor's constant buffer (float32), or None."""
        if not self.cvals:
            return None
        return np.concatenate(self.cvals).astype(np.float32)

    def value_of(self, e):
        """The number a constant element stands for."""
        mo = _CREF.fullmatch(e)
        if mo:
            k = int(mo.group(1))
            for block in self.cvals:
                if k < block.size:
                    return float(block[k])
                k -= block.size
        if e.startswith("R(") and e.endswith(")"):
            return float(e[2:-1])
        raise Rejected("not a constant")

    # -- elementwise ops at a time length ------------------------------------
    def broadcast(self, ops):
        out_shape = tuple(np.broadcast_shapes(*[o.shape for o in ops]))
        ops = [self.untime(o, out_shape) for o in ops]
        arrays, tdim, shape = super().broadcast(ops)
        self.active_n = None if tdim is None else shape[tdim]
        return arrays, tdim, shape

    def untime(self, o, out_shape):
        """A time operand of one sample broadcast over a longer axis:
        its sample as a time-free value."""
        if o.tdim is None or o.shape[o.tdim] != 1:
            return o
        pos = o.tdim + len(out_shape) - len(o.shape)
        if out_shape[pos] == 1:
            return o
        el = np.vectorize(lambda e: self.at_index(e, 1, 0),
                          otypes=[object])(o.elems) if o.elems.size else \
            o.elems
        return _Sym(np.expand_dims(el, o.tdim).reshape(o.shape), None,
                    o.shape)

    def reduce(self, x, dims, keepdim, combine, combine_all=None):
        if x.tdim is not None:
            self.active_n = x.shape[x.tdim]
        return super().reduce(x, dims, keepdim, combine, combine_all)

    def op_arange(self, node, a, kw, val):
        self.active_n = int(val.shape[0])
        return super().op_arange(node, a, kw, val)

    # -- samples by index ---------------------------------------------------
    def at_index(self, e, n, j):
        """Sample j of time element e, as a time-free value (a read of its
        plane after its loop's barrier)."""
        d = self.desc(e, n, j)
        if d[0] == "i":
            return _lit(j)
        if d[0] == "c":
            return f"cst[{d[1]}]"
        if d[0] == "f":
            return d[1]
        _, off, ln, kind, idx = d
        return self.emit(kind, lambda: self.plane_read(kind, off, ln, idx))

    def remap(self, x, index_lists):
        """x's time axis replaced by a new one whose sample k is sample
        index_lists[k] of x (None: the value fill)."""
        n = x.shape[x.tdim]
        fill, idxs = index_lists
        out = np.empty(x.elems.shape, object)
        for idx in np.ndindex(out.shape):
            e = x.elems[idx]
            out[idx] = self.new_map([("f", fill) if i is None
                                     else self.desc(e, n, i) for i in idxs])
        shape = list(x.shape)
        shape[x.tdim] = len(idxs)
        return _Sym(out, x.tdim, shape)

    def op_select(self, node, a, kw, val):
        x, dim = a[0], a[1] % len(a[0].shape)
        if dim != x.tdim:
            return super().op_select(node, a, kw, val)
        n = x.shape[dim]
        el = np.vectorize(lambda e: self.at_index(e, n, a[2] % n),
                          otypes=[object])(x.elems) if x.elems.size else \
            x.elems
        return _Sym(np.asarray(el, object), None,
                    x.shape[:dim] + x.shape[dim + 1:])

    def op_slice(self, node, a, kw, val):
        x = a[0]
        dim = (a[1] if len(a) > 1 else 0) % len(x.shape)
        if dim != x.tdim:
            return super().op_slice(node, a, kw, val)
        start = a[2] if len(a) > 2 and a[2] is not None else 0
        end = a[3] if len(a) > 3 and a[3] is not None else x.shape[dim]
        step = a[4] if len(a) > 4 else 1
        rng = list(range(*slice(start, end, step).indices(x.shape[dim])))
        if rng == list(range(x.shape[dim])):
            return x
        return self.remap(x, (None, rng))

    def op_flip(self, node, a, kw, val):
        x = a[0]
        for d in sorted(d % len(x.shape) for d in a[1]):
            if d == x.tdim:
                x = self.remap(x, (None, list(range(x.shape[d]))[::-1]))
            else:
                x = _Sym(np.flip(x.elems, self.eaxis(x, d)).copy(), x.tdim,
                         x.shape)
        return x

    def op_constant_pad_nd(self, node, a, kw, val):
        x, pad = a[0], list(a[1])
        fill = _lit(a[2] if len(a) > 2 else kw.get("value", 0.0))
        for k in range(len(pad) // 2):
            d = len(x.shape) - 1 - k
            lo, hi = pad[2 * k], pad[2 * k + 1]
            n = x.shape[d]
            idxs = ([None] * max(lo, 0) + list(range(max(-lo, 0),
                                                     n - max(-hi, 0)))
                    + [None] * max(hi, 0))
            if d == x.tdim:
                x = self.remap(x, (fill, idxs))
                continue
            ax = self.eaxis(x, d)
            parts = [np.full(x.elems.shape[:ax] + (1,)
                             + x.elems.shape[ax + 1:], fill, object)
                     if i is None else np.take(x.elems, [i], axis=ax)
                     for i in idxs]
            shape = list(x.shape)
            shape[d] = len(idxs)
            x = _Sym(np.concatenate(parts, axis=ax), x.tdim, shape)
        return x

    def join(self, xs, dim, shape, stack):
        tds = {x.tdim for x in xs if x.tdim is not None}
        if stack or tds != {dim}:
            return super().join(xs, dim, shape, stack)
        out = np.empty(shape[:dim] + shape[dim + 1:], object)
        for idx in np.ndindex(out.shape):
            descs = []
            for x in xs:
                if x.tdim == dim:
                    e = x.elems[idx]
                    descs += [self.desc(e, x.shape[dim], j)
                              for j in range(x.shape[dim])]
                else:
                    row = np.moveaxis(x.elems, dim, -1)[idx]
                    descs += [self.desc(e, len(row), j)
                              for j, e in enumerate(row)]
            out[idx] = self.new_map(descs)
        return _Sym(out, dim, shape)

    # -- reductions over time ------------------------------------------------
    def time_reduce(self, which, x, dims, keep):
        """sum / prod / amax / amin of x over dims, the time axis among
        them: each element's time series by the functor's fixed-order
        reduction of its plane, then the rest as the per-sample walk."""
        n = x.shape[x.tdim]
        others = [d for d in dims if d != x.tdim]
        if which in ("amax", "amin") and others:
            return self.stacked_extremum(which, x, dims, keep)
        out = np.empty(x.elems.shape, object)
        for idx in np.ndindex(out.shape):
            off, ln, kind = self.plane_of(x.elems[idx], n)
            out[idx] = self.emit(kind, lambda: f"ft_{which}<{kind}>(sh + "
                                 f"{off}, {ln}, lane, lanes)", vops=ln,
                                 tops=ln)
        shape = list(x.shape)
        if keep:
            shape[x.tdim] = 1
            y = _Sym(np.expand_dims(out, x.tdim).reshape(shape), None,
                     shape)
            rest = others
        else:
            del shape[x.tdim]
            y = _Sym(out, None, shape)
            rest = [d - (d > x.tdim) for d in others]
        if not rest:
            return y
        fn = {"sum": "+", "prod": "*"}[which]
        return _Gen.reduce(self, y, rest, keep,
                           lambda p, q: self.arith(fn, p, q))

    def stacked_extremum(self, which, x, dims, keep):
        """amax / amin over time and other axes: the K elements each output
        reduces stored into one plane of K n samples (element k's sample t
        at k n + t, each by the loop that computes it), then ft_amax /
        ft_amin over it: jax's rule over all of them at once (the extreme
        value, its tangent the mean of the tangents of every tied element
        and sample), in one fixed order."""
        n = x.shape[x.tdim]
        others = [d for d in dims if d != x.tdim]
        eaxes = [self.eaxis(x, d) for d in others]
        el = np.moveaxis(x.elems, eaxes, list(range(-len(eaxes), 0)))
        lead = el.shape[:el.ndim - len(eaxes)]
        flat = el.reshape(lead + (-1,))
        out = np.empty(lead, object)
        for idx in np.ndindex(lead):
            items = [e if e in self.seg_of else self.local_name(e, n)
                     for e in flat[idx]]
            kinds = {self.kind_of(e) for e in items}
            if "B" in kinds:
                raise Rejected("a boolean value across samples")
            kind = "S" if "S" in kinds else "R"
            total = len(items) * n
            off = self.sh_floats
            self.sh_floats += (self.p + 1 if kind == "S" else 1) * total
            for k, e in enumerate(items):
                val = e if self.kind_of(e) == kind else f"g_lift<S>({e})"
                seg = self.seg_of[e]
                seg.lines.append(f"    ft_store(sh + {off}, {total}, "
                                 f"{k * n} + ti, {val});")
                seg.open = False
            out[idx] = self.emit(kind, lambda: f"ft_{which}<{kind}>(sh + "
                                 f"{off}, {total}, lane, lanes)", vops=total,
                                 tops=total)
        shape = [1 if d in dims else m for d, m in enumerate(x.shape)
                 if keep or d not in dims]
        return _Sym(out.reshape(shape), None, shape)

    def _red_time(self, which, node, a, kw, val, base):
        dims, keep = self.red_args(a, kw)
        x = a[0]
        dl = list(range(len(x.shape))) if not dims else \
            [d % len(x.shape) for d in dims]
        if x.tdim is None or x.tdim not in dl:
            return base(node, a, kw, val)
        return self.time_reduce(which, x, dl, keep)

    def op_sum(self, node, a, kw, val):
        return self.red_time("sum", node, a, kw, val, super().op_sum)

    def op_mean(self, node, a, kw, val):
        dims, keep = self.red_args(a, kw)
        x = a[0]
        dl = dims or list(range(len(x.shape)))
        n = int(np.prod([x.shape[d] for d in dl]))
        s = self.op_sum(node, a, kw, val)
        return self.elementwise([s, n], lambda p, q: self.arith("/", p, q))

    def op_prod(self, node, a, kw, val):
        return self.red_time("prod", node, a, kw, val, super().op_prod)

    def op_amax(self, node, a, kw, val):
        return self.red_time("amax", node, a, kw, val, super().op_amax)

    def op_amin(self, node, a, kw, val):
        return self.red_time("amin", node, a, kw, val, super().op_amin)

    # -- contractions ----------------------------------------------------------
    def contract(self, x, y):
        """x [I,K] @ y [K,J] (the JAX allowlist's dot_general). Over a
        non-time axis: unrolled (the per-sample walk's), or, where both
        operands have a time axis among their free ones, a value with two
        time axes (pair_mm). Over time: against a constant, the functor's
        ft_dot_rows into a plane before the loop that reads it (dot_plane;
        the constant read by columns from the constant buffer), or ft_dot1
        for one output; else ft_vdot, both operands' planes reduced across
        the lanes (a time-free operand's contracted axis made a time axis
        first)."""
        (ni, nk), (nk2, nj) = x.shape, y.shape
        if nk != nk2:
            raise Rejected("contraction shapes")
        tx, ty = x.tdim == 1, y.tdim == 0
        if not tx and not ty:
            if x.tdim == 0 and y.tdim == 1:
                return self.pair_mm(x, y)
            if x.tdim is None and y.tdim is None:
                # a constant with a free axis of nt samples (a design
                # matrix times the parameters): that axis a time axis, its
                # rows read per sample from the constant buffer
                if ni == self.nt > 1 and self.values(x) is not None:
                    x = self.timed(x, 0)
                elif nj == self.nt > 1 and self.values(y) is not None:
                    y = self.timed(y, 1)
            t = x if x.tdim is not None else y
            self.active_n = None if t.tdim is None else t.shape[t.tdim]
            return _Gen.contract(self, x, y)
        if tx and ty:
            return self.vdot(x, y)
        s, c = (x, y) if tx else (y, x)
        cv = self.values(c)
        if cv is None:
            # a time-free operand that is not a constant: its contracted
            # axis as a time axis of maps
            if tx:
                return self.vdot(x, self.timed(y, 0))
            return self.vdot(self.timed(x, 1), y)
        # rows of the new time axis: c's free axis; stored by columns
        # (csrc/fulltime.cuh ft_dot_rows)
        rows = cv.T if tx else cv           # [n_out, K]
        nout = rows.shape[0]
        off = self.register(rows.T)
        # each output sample reads its whole row: 2 K operations a value or
        # tangent, of which 2 per zero of the row multiply by a known zero
        zeros = 2 * int(rows.size - np.count_nonzero(rows))
        out = np.empty((nj,) if ty else (ni,), object)
        for k in range(out.shape[0]):
            e = s.elems[k]
            poff, ln, kind = self.plane_of(e, nk)
            self.active_n = nout
            counted = self.value_ops
            if nout == 1:
                # one output: a time-free value, the same in every lane
                out[k] = self.emit(
                    kind, lambda: f"ft_dot1<{kind}>(cst + {off}, sh + "
                    f"{poff}, {ln}, lane, lanes)", vops=2 * nk, tops=2 * nk)
            else:
                doff = self.dot_plane(kind, off, nout, poff, ln)
                out[k] = self.emit(
                    kind, lambda i: self.plane_read(kind, doff, nout, i),
                    "ti", vops=2 * nk, tops=2 * nk)
            if self.value_ops != counted:
                self.zero_ops += zeros * (1 + self.p * (kind == "S"))
        if nout == 1:
            shape = (ni, 1) if tx else (1, nj)
            return _Sym(out.reshape(shape), None, shape)
        if tx:   # [I, J], time on J
            return _Sym(out, 1, (ni, nout))
        return _Sym(out, 0, (nout, nj))

    def dot_plane(self, kind, off, nout, poff, ln):
        """The plane of nout samples that the constant matrix at cst + off
        (by columns) times the plane at poff (ln samples) gives:
        ft_dot_rows at function scope, before the open loop (the plane's
        producer is closed: plane_of), then the warp's barrier; once per
        pair of operands."""
        key = ("rows", off, poff)
        if key not in self.cse:
            doff = self.sh_floats
            self.sh_floats += (self.p + 1 if kind == "S" else 1) * nout
            seg = self._open_seg()
            at = len(self.items) - (seg is not None)
            self.items[at:at] = [
                f"    ft_dot_rows<{kind}>(cst + {off}, {nout}, sh + {poff}, "
                f"{ln}, {nout}, sh + {doff}, lane, lanes);",
                "    __syncwarp();"]
            self.cse[key] = doff
        return self.cse[key]

    def values(self, c):
        """The numbers a time-free operand's elements stand for (a
        constant), or None."""
        if c.tdim is not None:
            return None
        if getattr(c, "conc", None) is not None:
            return np.asarray(c.conc, np.float64)
        try:
            return np.vectorize(self.value_of, otypes=[float])(c.elems) \
                if c.elems.size else np.zeros(c.shape)
        except Rejected:
            return None

    def timed(self, x, axis):
        """A time-free 2-D operand with its axis `axis` made a time axis
        (its columns or rows as maps, or one value where uniform)."""
        el = self.drop_uniform(x.elems, axis)
        return _Sym(np.asarray(el, object).reshape(-1), axis, x.shape)

    def vdot(self, x, y):
        """x [I,K] @ y [K,J], time on K in both: each output ft_vdot of the
        two planes, a time-free value computed in every lane."""
        (ni, nk), nj = x.shape, y.shape[1]
        out = np.empty((ni, nj), object)
        for i in range(ni):
            for j in range(nj):
                pa, na, ka = self.plane_of(x.elems[i], nk)
                pb, nb, kb = self.plane_of(y.elems[j], nk)
                kind = "S" if "S" in (ka, kb) else "R"
                both = ka == kb == "S"
                out[i, j] = self.emit(
                    kind, lambda: f"ft_vdot<{kind}, {ka}, {kb}>(sh + {pa}, "
                    f"sh + {pb}, {nk}, lane, lanes)", vops=2 * nk,
                    tops=(4 if both else 2) * nk)
        return _Sym(out, None, (ni, nj))

    # -- values with two time axes ----------------------------------------
    def dispatch(self, node, args, kw):
        if any(isinstance(x, _Pair) for x in _flat(args)
               + _flat(list(kw.values()))):
            name = node.target._schema.name.split("::")[-1] \
                if isinstance(node.target, torch._ops.OpOverload) else ""
            if name.rstrip("_") not in _PAIR_OPS:
                args = self.realized(args)
                kw = {k: v for k, v in zip(kw, self.realized(
                    list(kw.values())))}
        return super().dispatch(node, args, kw)

    def realized(self, xs):
        """xs with each pair on a virtual time axis made one time axis of
        elements (realize); another pair is refused."""
        out = []
        for x in xs:
            if isinstance(x, (list, tuple)):
                x = type(x)(self.realized(x))
            elif isinstance(x, _Pair):
                if x.vpos is None:
                    raise Rejected("values with two time axes")
                x = self.realize(x)
            out.append(x)
        return out

    def realize(self, x):
        """A pair on a virtual time axis as a value with one time axis, the
        real one: each sample of the virtual axis an element, its leaves
        there read at that sample (time-free: a constant's)."""
        ta, tb = x.tdims
        real = ta if x.vpos == tb else tb
        lane = 0 if real == ta else 1
        nv = x.shape[x.vpos]
        self.active_n = x.shape[real]
        out = np.empty(x.elems.shape + (nv,), object)
        for idx in np.ndindex(x.elems.shape):
            for j in range(nv):
                out[idx + (j,)] = self.peval(x.elems[idx], lane, {}, j)
        out = np.moveaxis(out, -1, x.vpos - (real < x.vpos))
        return _Sym(out, real, x.shape)

    def elementwise(self, ops, fn):
        ops = [self.operand(o) for o in ops]
        if any(isinstance(o, _Pair) for o in ops):
            return self.pair_elementwise(ops, fn)
        try:
            out_shape = tuple(np.broadcast_shapes(*[o.shape for o in ops]))
        except ValueError:
            raise Rejected("broadcast")
        rank = len(out_shape)
        ops = [self.untime(o, out_shape) for o in ops]
        tpos = {o.tdim + rank - len(o.shape) for o in ops
                if o.tdim is not None}
        if len(tpos) == 2:
            return self.pair_elementwise(ops, fn)
        if len(tpos) == 1:
            vpos = self.virtual_axis(ops, out_shape, next(iter(tpos)))
            if vpos is not None:
                return self.pair_elementwise(ops, fn, vpos)
        return super().elementwise(ops, fn)

    def virtual_axis(self, ops, out_shape, tpos):
        """The one axis of nt samples, other than the time axis tpos, along
        which a constant operand varies, or None: that axis is taken as a
        second time axis, so a reduction over either keeps no [nt, nt]
        elements."""
        rank = len(out_shape)
        found = set()
        for o in ops:
            if o.tdim is not None or self.values(o) is None:
                continue
            off = rank - len(o.shape)
            el = o.elems.reshape(o.shape)
            for d, m in enumerate(o.shape):
                if (m == self.nt and d + off != tpos and m > 1
                        and not (np.take(el, [0], axis=d) == el).all()):
                    found.add(d + off)
        return found.pop() if len(found) == 1 else None

    def pair_elementwise(self, ops, fn, vpos=None):
        """fn of operands whose time axes fall on two axes of the output
        (one of them vpos, a virtual one, where given): a _Pair whose nodes
        record fn and the operands' nodes (the lines are emitted where a
        reduction ends the pair)."""
        out_shape = tuple(np.broadcast_shapes(*[o.shape for o in ops]))
        rank = len(out_shape)
        ops = [o if isinstance(o, _Pair) else self.untime(o, out_shape)
               for o in ops]
        pos = set() if vpos is None else {vpos}
        real = set()
        virtual = set()
        for o in ops:
            off = rank - len(o.shape)
            if isinstance(o, _Pair):
                pos |= {d + off for d in o.tdims}
                real |= {d + off for d in o.tdims if d != o.vpos}
                if o.vpos is not None:
                    virtual.add(o.vpos + off)
            elif o.tdim is not None:
                pos.add(o.tdim + off)
                real.add(o.tdim + off)
        if len(pos) != 2:
            raise Rejected("time axes misaligned")
        if vpos is not None:
            virtual.add(vpos)
        virtual -= real
        ta, tb = sorted(pos)
        ne = tuple(m for d, m in enumerate(out_shape) if d not in (ta, tb))
        arrays = [self.pair_operand(o, out_shape, ta, tb, ne) for o in ops]
        out = np.empty(ne, object)
        for idx in np.ndindex(ne):
            out[idx] = _PNode(fn, [a[idx] for a in arrays])
        return _Pair(out, (ta, tb), out_shape,
                     virtual.pop() if len(virtual) == 1 else None)

    def pair_operand(self, o, out_shape, ta, tb, ne):
        """Operand o's nodes over the pair's other axes ne (out_shape
        less ta and tb), broadcast."""
        rank = len(out_shape)
        off = rank - len(o.shape)
        if isinstance(o, _Pair):
            el = o.elems.reshape((1,) * (len(ne) - o.elems.ndim)
                                 + o.elems.shape)
            return np.broadcast_to(el, ne)
        full = list(o.shape)
        if o.tdim is not None:
            # a time axis on ta or tb: its elements are leaves there; its
            # axis on the other must be uniform
            axis = 0 if o.tdim + off == ta else 1
            n = out_shape[o.tdim + off]
            other = (tb if axis == 0 else ta) - off
            el = o.elems
            eshape = full[:o.tdim] + full[o.tdim + 1:]
            el = el.reshape(eshape)
            if 0 <= other:
                ax = other - (other > o.tdim)
                el = np.expand_dims(self.uniform(el, ax), ax)
            leaf = np.vectorize(lambda e: _PLeaf(e, axis, n),
                                otypes=[object])(el) if el.size else el
            shape = list(leaf.shape[:o.tdim]) + [1] + list(
                leaf.shape[o.tdim:])
        else:
            el = o.elems.reshape(full)
            ia, ib = ta - off, tb - off
            vary = [ax for ax in (ia, ib) if 0 <= ax and full[ax] != 1
                    and not (np.take(el, [0], axis=ax) == el).all()]
            if len(vary) == 2:
                leaf = self.pair_const(o, ia, ib)
                shape = [1 if d in (ia, ib) else m
                         for d, m in enumerate(full)]
            else:
                for ax in (ia, ib):
                    if 0 <= ax and ax not in vary:
                        el = np.take(el, [0], axis=ax)
                if vary:
                    ax = vary[0]
                    axis = 0 if ax == ia else 1
                    n = out_shape[ax + off]
                    maps = self.drop_uniform(el, ax)
                    leaf = np.expand_dims(np.vectorize(
                        lambda e: _PLeaf(e, axis, n), otypes=[object])(maps),
                        ax)
                else:
                    leaf = el
                shape = list(leaf.shape)
        leaf = np.asarray(leaf, object).reshape(
            (1,) * (rank - len(shape)) + tuple(shape))
        leaf = np.squeeze(leaf, axis=(ta, tb))
        return np.broadcast_to(leaf, ne)

    def uniform(self, el, ax):
        """el along axis ax, where all its elements are one: that one."""
        first = np.take(el, [0], axis=ax)
        if el.shape[ax] != 1 and not (el == first).all():
            raise Rejected("a value with a time axis varying along another")
        return np.take(el, 0, axis=ax)

    def pair_const(self, o, ia, ib):
        """A constant varying along both time axes: its values registered
        in the constant buffer, a _PConst per element of its other axes
        (ia, ib its axes there, in o's shape)."""
        cv = self.values(o)
        if cv is None:
            raise Rejected("a value varying along two time axes that is "
                           "not a constant")
        cv = np.asarray(cv, np.float64).reshape(o.shape)
        base = self.register(cv)
        strides = [st // cv.itemsize for st in
                   np.ascontiguousarray(cv).strides]
        rest = [d for d in range(cv.ndim) if d not in (ia, ib)]
        out = np.empty(tuple(cv.shape[d] for d in rest), object)
        for idx in np.ndindex(out.shape):
            k = base + sum(i * strides[d] for i, d in zip(idx, rest))
            out[idx] = _PConst(k, strides[ia], strides[ib])
        shape = [1 if d in (ia, ib) else m for d, m in enumerate(cv.shape)]
        return out.reshape(shape)

    def pair_mm(self, x, y):
        """x [I,K] @ y [K,J] with time on I and on J: a value with two
        time axes, each element the sum over k of the products."""
        nk = x.shape[1]
        mul = lambda p, q: self.arith("*", self.to_real(p),  # noqa: E731
                                      self.to_real(q))
        add = lambda p, q: self.arith("+", p, q)  # noqa: E731
        acc = None
        for k in range(nk):
            term = _PNode(mul, [_PLeaf(x.elems[k], 0, x.shape[0]),
                                _PLeaf(y.elems[k], 1, y.shape[1])])
            acc = term if acc is None else _PNode(add, [acc, term])
        return _Pair(np.array(acc, object), (0, 1), (x.shape[0], y.shape[1]))

    def pair_reduce(self, which, x, dims, keep):
        """sum / prod / amax / amin of a value with two time axes over
        dims, one or both of its time axes among them: per element, a
        lane a sample of the kept axis (ta where both go) and an inner
        loop over the other (pair_fold), then the rest of dims as for any
        value. An extremum reduces every axis of dims at once, as jax's
        rule shares the tangent among all ties: over both time axes in
        two passes over the lanes (pair_extremum)."""
        ta, tb = x.tdims
        tdl = [d for d in dims if d in (ta, tb)]
        if not tdl:
            if x.vpos is None:
                raise Rejected("a reduction that keeps two time axes")
            return self.reduce_one(which, self.realize(x), dims, keep)
        red = tdl[-1]
        kept = ta if red == tb else tb
        lane = 0 if kept == ta else 1
        n_lane, n_red = x.shape[kept], x.shape[red]
        for node in x.elems.flat:
            for leaf in self.pair_leaves(node):
                if isinstance(leaf, _PLeaf) and leaf.axis != lane \
                        and leaf.e in self.seg_of:
                    self.materialize(leaf.e)
        if which in ("amax", "amin"):
            return self.pair_extremum(which, x, dims, keep, lane)
        self.active_n = n_lane
        seg = self.segment(n_lane)
        out = np.empty(x.elems.shape, object)
        for idx in np.ndindex(out.shape):
            out[idx] = self.pair_fold(which, [x.elems[idx]], lane, n_red,
                                      seg)
        shape = list(x.shape)
        if keep:
            shape[red] = 1
            tdim = kept
            out = np.expand_dims(out, red - (kept < red))
        else:
            del shape[red]
            tdim = kept - (red < kept)
        y = _Sym(out, tdim, shape)
        rest = [d - (d > red and not keep) for d in dims if d != red]
        return self.reduce_one(which, y, rest, keep) if rest else y

    def pair_extremum(self, which, x, dims, keep, lane):
        """amax / amin of a pair over dims (a time axis among them): the
        elements each output reduces (along dims' other axes) folded
        together per lane (pair_fold); where dims hold both time axes,
        the lanes' extreme values stored and reduced (M), then a second
        loop over the lanes folds each lane's ties with M (their tangents'
        sum and count, ft_tie_pack) into a plane whose sum gives jax's
        mean of the tied tangents (ft_tie_result)."""
        ta, tb = x.tdims
        kept = (ta, tb)[lane]
        red = (tb, ta)[lane]
        n_lane, n_red = x.shape[kept], x.shape[red]
        others = [d for d in dims if d not in (ta, tb)]
        eaxes = [d - (d > ta) - (d > tb) for d in others]
        el = np.moveaxis(x.elems, eaxes, list(range(-len(eaxes), 0)))
        lead = el.shape[:el.ndim - len(eaxes)]
        flat = el.reshape(lead + (-1,))
        both = kept in dims
        out = np.empty(lead, object)
        for idx in np.ndindex(lead):
            nodes = list(flat[idx])
            self.active_n = n_lane
            seg = self.segment(n_lane)
            res = self.pair_fold(which, nodes, lane, n_red, seg,
                                 values_only=both)
            if not both:
                out[idx] = res
                continue
            off, n, _ = self.materialize(res)
            m = self.emit("R", lambda: f"ft_{which}<R>(sh + {off}, {n}, "
                          "lane, lanes)", vops=n)
            self.active_n = n_lane
            seg = self.segment(n_lane)
            tied = self.pair_fold(which, nodes, lane, n_red, seg, ties=m)
            if tied is None:
                out[idx] = m
                continue
            off, n, _ = self.materialize(tied)
            tot = self.emit("S", lambda: f"ft_sum<S>(sh + {off}, {n}, "
                            "lane, lanes)", vops=n, tops=n)
            out[idx] = self.emit("S", lambda t: f"ft_tie_result({m}, {t}, "
                                 f"g_val({t}))", tot, vops=1, tops=1)
        if both:
            shape = [1 if d in dims else m for d, m in enumerate(x.shape)
                     if keep or d not in dims]
            return _Sym(out.reshape(shape), None, shape)
        shape = [1 if d in dims else m for d, m in enumerate(x.shape)
                 if keep or d not in dims]
        tdim = kept - sum(1 for d in dims if d < kept and not keep)
        return _Sym(out.reshape(shape[:tdim] + shape[tdim + 1:]), tdim,
                    shape)

    def reduce_one(self, which, y, dims, keep):
        """sum / prod / amax / amin of a value with one time axis (or
        none) over dims."""
        if y.tdim in dims:
            return self.time_reduce(which, y, dims, keep)
        if which in ("amax", "amin"):
            return _Gen.reduce(self, y, dims, keep, None, lambda items:
                               self.extremum(which == "amax", items))
        fn = {"sum": "+", "prod": "*"}[which]
        return _Gen.reduce(self, y, dims, keep,
                           lambda p, q: self.arith(fn, p, q))

    @staticmethod
    def pair_leaves(node, seen=None):
        seen = set() if seen is None else seen
        if id(node) in seen:
            return []
        seen.add(id(node))
        if isinstance(node, _PNode):
            out = []
            for k in node.kids:
                out += _FullGen.pair_leaves(k, seen)
            return out
        return [node]

    def pair_fold(self, which, nodes, lane, n_red, seg, values_only=False,
                  ties=None):
        """Elements of a pair (nodes) reduced over its other axis, and over
        one another, in the lane's loop seg: a loop over the n_red samples
        tj (the inner loop), the nodes' lines inside it, folded into an
        accumulator, a name of seg. amax / amin: two passes, the extreme
        value, then ft_tie's rule (values_only: the first pass alone);
        ties (a time-free extreme value): one pass folding the ties with
        it into ft_tie_pack's count and tangent sum (None for real
        values, which have no tangent)."""
        inner = _Inner(self.n_inner, seg, seg.n * n_red)
        self.n_inner += 1
        self.inner = inner
        try:
            memo = {}
            xs = [self.to_real(self.peval(nd, lane, memo)) for nd in nodes]
            xs = [self.localize(x, seg) if self.is_local(x)
                  and not self.is_inner(x) else x for x in xs]
        finally:
            self.inner = None
        if not seg.open or any(self.seg_of.get(x, seg) is not seg
                               for x in xs):
            raise Rejected("a pair's loop closed while it was walked")
        kind = "S" if any(self.kind_of(x) == "S" for x in xs) else "R"
        body = ["  " + ln for ln in inner.lines]
        loop = f"    for (int tj = 0; tj < {n_red}; ++tj) {{"
        n = seg.n * n_red
        if which in ("sum", "prod"):
            op = "+" if which == "sum" else "*"
            init = "R(0.0)" if which == "sum" else "R(1.0)"
            acc = self._new_name(kind)
            seg.lines += ([f"    {kind} {acc} = g_lift<{kind}>({init});",
                           loop] + body
                          + [f"      {acc} = {acc} {op} {x};" for x in xs]
                          + ["    }"])
            self.count(kind, len(xs), len(xs) * (1 if op == "+" else 3), n)
        elif ties is not None:
            if kind == "R":
                return None
            tsum, cnt, acc = (self._new_name(k) for k in "SRS")
            seg.lines += ([f"    S {tsum} = g_lift<S>(R(0.0));",
                           f"    R {cnt} = R(0.0);", loop] + body
                          + [f"      ft_tie({tsum}, {cnt}, g_lift<S>({x}), "
                             f"{ties});" for x in xs]
                          + ["    }", f"    const S {acc} = "
                             f"ft_tie_pack({tsum}, {cnt});"])
            self.count("S", 2 * len(xs), len(xs), n)
        else:
            mx = "g_max" if which == "amax" else "g_min"
            m = self._new_name("R")
            inf = "-INFINITY" if which == "amax" else "INFINITY"
            seg.lines += ([f"    R {m} = R({inf});", loop] + body
                          + [f"      {m} = {mx}({m}, g_val({x}));"
                             for x in xs] + ["    }"])
            self.count("R", len(xs), 0, n)
            acc = m
            if kind == "S" and not values_only:
                tsum, cnt, acc = (self._new_name(k) for k in "SRS")
                seg.lines += ([f"    S {tsum} = g_lift<S>(R(0.0));",
                               f"    R {cnt} = R(0.0);", loop] + body
                              + [f"      ft_tie({tsum}, {cnt}, "
                                 f"g_lift<S>({x}), {m});" for x in xs]
                              + ["    }", f"    const S {acc} = "
                                 f"ft_tie_result({m}, {tsum}, {cnt});"])
                # the second pass runs the inner lines again
                self.value_ops += inner.vops * n
                self.tangent_ops += inner.tops * self.p * n
                self.count("S", 2 * len(xs), len(xs), n)
        self.seg_of[acc] = seg
        return acc

    def peval(self, node, lane, memo, fixed=None):
        """A pair's node as an expression: a leaf on the lane's axis its
        element (a name of the lane's loop where it is time-local), one on
        the other axis read at tj (inner_read), or at sample `fixed` of
        it where given (realize)."""
        key = id(node)
        if key in memo:
            return memo[key]
        if isinstance(node, _PNode):
            val = node.fn(*[self.peval(k, lane, memo, fixed)
                            for k in node.kids])
        elif isinstance(node, _PLeaf):
            val = node.e if node.axis == lane else (
                self.inner_read(node.e, node.n) if fixed is None
                else self.at_index(node.e, node.n, fixed))
        elif isinstance(node, _PConst):
            sl, si = (node.sa, node.sb) if lane == 0 else (node.sb, node.sa)
            if fixed is None:
                val = self.emit("R", lambda i, j: f"cst[{node.off} + {sl} * "
                                f"{i} + {si} * {j}]", "ti", "tj")
            else:
                val = self.emit("R", lambda i: f"cst[{node.off + si * fixed}"
                                f" + {sl} * {i}]", "ti")
        else:
            val = node
        memo[key] = val
        return val

    def inner_read(self, e, n):
        """Sample tj of time element e (n samples)."""
        if e == "t":
            return self.emit("R", lambda j: f"R({j})", "tj")
        if e.startswith("@m"):
            return self.map_expr(e, self.inner.seg, "tj", n)
        if e in self.seg_of:
            off, ln, kind = self.planes[e]
            return self.emit(kind, lambda j: self.plane_read(kind, off, ln, j),
                             "tj")
        return e

    def red_time(self, which, node, a, kw, val, base):
        if isinstance(a[0], _Pair):
            dims, keep = self.red_args(a, kw)
            x = a[0]
            dl = list(range(len(x.shape))) if not dims else \
                [d % len(x.shape) for d in dims]
            return self.pair_reduce(which, x, dl, keep)
        return self._red_time(which, node, a, kw, val, base)

    # -- the output and the source ---------------------------------------------
    def finish(self, out, want):
        if out.shape != want:
            raise Rejected(f"output shape {out.shape}")
        nt = want[0]
        if out.tdim == 0:
            e = out.elems.reshape(-1)[0]
        else:
            e = self.drop_uniform(out.elems, 0)
            e = e.reshape(-1)[0] if isinstance(e, np.ndarray) else e
        kind = self.kind_of(e)
        if kind == "B":
            raise Rejected("boolean output")
        name = self.local_name(e, nt)
        seg = self.seg_of[name]
        val = name if self.kind_of(name) == "S" else f"g_lift<S>({name})"
        seg.lines.append(f"    ft_store(out, {nt}, ti, {val});")
        seg.open = False
        self.out_expr = name

    def source(self):
        body = []
        for item in self.items:
            if isinstance(item, str):
                body.append(item)
                continue
            body.append(f"    for (int ti = lane; ti < {item.n}; "
                        "ti += lanes) {")
            body.append("      const R t = R(ti);")
            body.append("      (void)t;")
            body += ["  " + ln for ln in item.lines]
            body.append("    }")
            body.append("    __syncwarp();")
        body = "\n".join(body)
        return f"""struct GenModel {{
  static constexpr int P = {self.p};
  static constexpr int NS = {self.nsupp};
  static constexpr int NT = {self.nt};
  // floats of shared memory the time-mixing ops read, and of the
  // constant buffer
  static constexpr int SMEM = {self.sh_floats};
  static constexpr int NCONST = {self.nconst};

  // the model over the whole time axis of one voxel (csrc/fulltime.cuh's
  // contract), lane `lane` of `lanes` taking samples lane, lane + lanes,
  // ...: the signal and the model-space Jacobian into out [(P+1) x NT]
  // (value at out[t], tangent i at out[(1+i) NT + t]); sh holds SMEM
  // floats, cst the NCONST constants; every lane calls it (device code:
  // its loops end in the warp's barrier)
  template <class S, class R>
  __device__ static void run(const S* m, const R* supp,
                             const R* __restrict__ cst, R* sh,
                             R* out, int lane, int lanes) {{
    (void)supp;
    (void)cst;
    (void)sh;
{body}
  }}
}};
"""


def _flat(xs):
    out = []
    for x in xs:
        out += _flat(x) if isinstance(x, (list, tuple)) else [x]
    return out
