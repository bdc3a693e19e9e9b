"""Time-local derivation of a model for the whole-loop kernel, and the
CUDA model functor generated from it.

Port of fabber_core_tpu/models/base.py derive_time_local_eval
(:254-352). The JAX package traces a plugin's plain ``evaluate`` into a
jaxpr, checks it against a Mosaic-safe primitive allowlist and lets the
Pallas kernel vmap it over the voxel lanes. A CUDA kernel cannot trace
a torch function, so here the trace is turned into C++:

  probe     torch.fx make_fx (fake tensors, so value-dependent control
            flow fails the trace) of model.evaluate(params [P],
            EvalContext(data=<forbidden>, coords=<forbidden>,
            suppdata=supp [S] or None, nt=nt)); every use of a forbidden
            sentinel raises, a presence check like ``ctx.data is None``
            included, since it takes the data branch;
  walk      each aten node of the graph against an allowlist (the torch
            counterpart of _KERNEL_SAFE_PRIMITIVES), with the time axis
            tracked by where it came from: arange(ctx.nt) becomes the
            scalar sample index t. An op that selects, slices, reverses,
            permutes the elements of or reduces along that axis rejects
            the model, as does an op outside the allowlist (a custom
            autograd.Function or custom op among them) or an output that
            is not [nt];
  generate  each node becomes lines of a C++ functor in a scalar type,
            the non-time axes unrolled. Values that depend on the
            parameters are of type S (a forward dual number in the
            kernel, csrc/dual.cuh), the others of type R (float in the
            kernel), so a value that does not depend on the parameters
            carries no tangent (one that does carries all P).

The JAX probe admits models that reduce over time (its allowlist has
reduce_sum, rev and pad); this one does not: such a model keeps the
generic-Jacobian route (ROADMAP Queue 3 item 19). A rejected model is a
route decision made before any launch, never a fallback after a failure.

The same generator turns a model's ``time_signal(params, t)`` (P
scalar planes and a scalar t) into a functor, for time_signal plugins
that have no hand-written one (kernel_model()).
"""

import math

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
    time sample for the value and for the P tangents, and (from evaluate
    only, else None) time_planes: the intermediates of the trace that
    carry the time axis, the JAX engine's measure of the generic mode's
    VMEM (fabber_core_tpu/models/base.py _count_time_planes), which the
    route gate's copy of its picker reads (ops/fused_loop_nl.py
    pick_nl_block)."""

    def __init__(self, fn, nparams, nsupp, source, value_ops, tangent_ops,
                 time_planes=None):
        self.fn = fn
        self.time_planes = time_planes
        self.nparams = nparams
        self.nsupp = nsupp
        self.source = source
        self.value_ops = value_ops
        self.tangent_ops = tangent_ops
        # Q -> the loaded library of its kernel (ops/_cuda.py
        # build_generated), set where it is built
        self.libs = {}

    def __call__(self, pvec, *supp):
        return self.fn(pvec, *supp)


def derive_time_local_eval(model, nt, nparams, nsupp=0):
    """A TimeLocalEval if ``model.evaluate`` is data-free (it reads only
    the parameters, ctx.nt, static model config and, when the run has
    it, nsupp > 0, per-voxel ctx.suppdata) and time-local, and every op
    it traces to is one the generator knows; else None."""
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
        gen = _Gen(gm, nparams, nsupp, nt)
        gen.bind_inputs(["m"] + (["supp"] if nsupp else []),
                        [(nparams,)] + ([(nsupp,)] if nsupp else []))
        out = gen.run()
        gen.finish(out, (nt,))
    except Exception:   # a failed trace or a rejected op: the route says no
        return None
    return TimeLocalEval(fn, nparams, nsupp, gen.source(), gen.value_ops,
                         gen.tangent_ops, count_time_planes(gm, nt))


def count_time_planes(gm, nt):
    """The nodes of a make_fx trace whose output carries the time axis (a
    dimension of length nt), at least 1: the count of JAX's
    _count_time_planes (jaxpr equation outputs with nt in their shape)
    over the port's own trace. The traces are not the same program (an
    aten op may stand for a pair of lax primitives), but on the models
    tests/test_torch_wide_nl.py holds them against (a Gaussian, its
    suppdata form, exp sums of 1-5 components) the counts agree."""
    n = 0
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        vals = node.meta.get("val")
        for v in vals if isinstance(vals, (tuple, list)) else (vals,):
            if torch.is_tensor(v) and nt in tuple(v.shape):
                n += 1
    return max(n, 1)


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
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(fn, tracing_mode="fake")(*args)


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

    def emit(self, kind, expr, vops=0, tops=0):
        # the lines are pure: an expression emitted before is reused
        # (so a time-free tensor of equal elements stays uniform)
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
        if not torch.is_tensor(val) or val.numel() > 4096:
            raise Rejected("constant")
        v = val.detach().cpu()
        if v.dtype == torch.bool:
            el = np.vectorize(_lit, otypes=[object])(v.numpy())
        else:
            el = np.vectorize(_lit, otypes=[object])(
                v.double().numpy())
        return _Sym(np.asarray(el, object).reshape(tuple(v.shape)), None,
                    v.shape)

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
        return self.emit(kind, f"{a} {op} {b}", 1, tops)

    def to_real(self, e):
        if self.kind_of(e) != "B":
            return e
        return self.emit("R", f"({e} ? R(1.0) : R(0.0))")

    def unary(self, name, a):
        a = self.to_real(a)
        fn, vops, tops = _UNARY[name]
        kind = self.kind_of(a)
        if fn == "-":
            return self.emit(kind, f"-{a}", vops, tops)
        return self.emit(kind, f"{fn}({a})", vops, tops)

    def flat(self, name, a):
        a = self.to_real(a)
        return self.emit("R", f"{_FLAT[name]}(g_val({a}))", 1)

    def compare(self, op, a, b):
        a, b = self.to_real(a), self.to_real(b)
        return self.emit("B", f"g_val({a}) {op} g_val({b})", 1)

    def logic(self, op, a, b):
        if self.kinds(a, b) != ["B", "B"]:
            raise Rejected("logic on non-booleans")
        return self.emit("B", f"{a} {op} {b}", 1)

    def binfn(self, fn, a, b, tops):
        a, b = self.to_real(a), self.to_real(b)
        kind = "S" if "S" in self.kinds(a, b) else "R"
        return self.emit(kind, f"{fn}({a}, {b})", 1, tops)

    def pow_(self, a, b):
        a, b = self.to_real(a), self.to_real(b)
        ka, kb = self.kinds(a, b)
        kind = "S" if "S" in (ka, kb) else "R"
        if kb == "R" and b.startswith("R("):
            return self.emit(kind, f"g_powc({a}, {b})", 1, 3)
        return self.emit(kind, f"g_pow({a}, {b})", 1, 8)

    def where(self, c, a, b):
        if self.kind_of(c) != "B":
            raise Rejected("where condition")
        a, b = self.to_real(a), self.to_real(b)
        kind = "S" if "S" in self.kinds(a, b) else "R"
        return self.emit(kind, f"g_where({c}, {a}, {b})", 1, 1)

    def clamp(self, x, lo, hi):
        x = self.to_real(x)
        for bnd in (lo, hi):
            if bnd is not None and self.kind_of(bnd) == "S":
                raise Rejected("clamp bound depends on the parameters")
        lo = "R(-INFINITY)" if lo is None else lo
        hi = "R(INFINITY)" if hi is None else hi
        # csrc/dual.cuh: a max then a min, jax's clip
        return self.emit(self.kind_of(x), f"g_clamp({x}, {lo}, {hi})", 2,
                         6)

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
                  self.emit("S", f"g_lift<S>({e})") for e in items]
        flag = "true" if is_max else "false"
        return self.emit("S", f"g_extremum<{flag}>({', '.join(lifted)})",
                         len(items) - 1, len(items) + 1)

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
        target = node.target
        if not isinstance(target, torch._ops.OpOverload):
            raise Rejected(f"call {target}")
        if target.namespace != "aten":
            raise Rejected(f"custom op {target}")
        name = target._schema.name.split("::")[-1]
        val = node.meta.get("val")
        if torch.is_tensor(val) and (val.dtype.is_complex
                                     or val.dtype == torch.float64):
            raise Rejected(f"{name} computes in {val.dtype}")
        args = [self.arg(a) for a in node.args]
        kw = {k: self.arg(v) for k, v in node.kwargs.items()}
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
                                        "B", f"g_val({e}) != R(0.0)", 1))
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
        if kw.get("rounding_mode") is not None:
            raise Rejected("rounding division")
        return self.elementwise(a[:2], lambda p, q: self.arith("/", p, q))

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
                x = self.emit("B", f"g_val({x}) != R(0.0)", 1)
            return self.emit("B", f"!{x}", 1)
        return self.elementwise([a[0]], f)

    # the time axis and constants
    def op_arange(self, node, a, kw, val):
        n = int(val.shape[0])
        if len(a) == 1:
            start, step = 0, 1
        else:
            start, step = a[0], a[2] if len(a) > 2 else 1
        if self.nt is not None and n == self.nt:
            if (start, step) == (0, 1):
                return _Sym(np.array("t", object), 0, (n,))
            e = self.emit("R", f"R({float(start)!r} + {float(step)!r} * "
                          "(double)t)")
            return _Sym(np.array(e, object), 0, (n,))
        vals = np.arange(n, dtype=np.float64) * float(step) + float(start)
        return _Sym(np.array([_lit(v) for v in vals], object), None, (n,))

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
