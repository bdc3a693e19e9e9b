"""jax's derivative rules at kinks, for the port's forward-mode Jacobians.

The JAX package differentiates its models with jax; the port with
torch.func (jacfwd, jvp). Their rules agree everywhere except at a kink:

  op                  jax.jvp                    torch.func.jvp
  abs(x) at 0         +t (selects on x >= 0)     0 (sgn(x) t)
  clamp at a bound    t/2 (jnp.clip is           t (where(lo <= x <= hi))
                      min(max(x, lo), hi), and
                      max/min split a tie)
  maximum/minimum tie t/2 each side              t/2 each side
  amax/amin ties      shared evenly              shared evenly
  hardtanh at +-1     t (jax.nn.hard_tanh is     0 (where(-1 < x < 1))
                      where(x > 1, 1, where(x <
                      -1, -1, x)))

A generic model's initial centre is its prior mean, 0 by default, so
abs(p) starts on its kink: with torch's rule its Jacobian column is 0
and the parameter cannot move, with jax's it is 1.

JaxKinks(fn).at(*args) traces fn with make_fx (fake tensors, so a
value-dependent Python branch fails the trace; the real tensors fn
closes over, a convolution matrix, enter as constants) at the shapes, dtypes
and devices of the arguments it is called with (once per such key),
functionalized (torch.func.functionalize: an in-place abs_, clamp_ or
hardtanh_ is traced as abs, clamp or hardtanh), and rewrites the aten
graph: abs(x) becomes where(x >= 0, x, -x), every clamp, clamp_min and
clamp_max becomes maximum and minimum against its bounds, whose ties
split the tangent as jax's do, and hardtanh at its default bounds (-1,
1) becomes jax.nn.hard_tanh's nested where (other bounds have no jax
counterpart and keep torch's rule). The values are fn's.
A function that does not trace (value-dependent control flow, .item(),
numpy) is called as it is and keeps torch's rules (ROADMAP Queue 3
item 20).
"""

import torch

_aten = torch.ops.aten
_CLAMPS = {
    _aten.clamp.default: (1, 2), _aten.clamp.Tensor: (1, 2),
    _aten.clamp_min.default: (1, None), _aten.clamp_min.Tensor: (1, None),
    _aten.clamp_max.default: (None, 1), _aten.clamp_max.Tensor: (None, 1),
}


_HARDTANH_DEFAULTS = (-1.0, 1.0)


def _arg(node, i, name):
    if i is None:
        return None
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name)


def rewrite_kinks(gm):
    """Rewrite a make_fx GraphModule in place (module docstring); returns
    the number of nodes rewritten."""
    g = gm.graph
    n = 0
    for node in list(g.nodes):
        if node.op != "call_function":
            continue
        target = node.target
        if target is _aten.abs.default:
            x = node.args[0]
            with g.inserting_before(node):
                ge = g.call_function(_aten.ge.Scalar, (x, 0))
                neg = g.call_function(_aten.neg.default, (x,))
                new = g.call_function(_aten.where.self, (ge, x, neg))
        elif target is _aten.hardtanh.default and _hardtanh_bounds(
                node) == _HARDTANH_DEFAULTS:
            x = node.args[0]
            with g.inserting_before(node):
                lo, hi = (g.call_function(_aten.full_like.default, (x, b))
                          for b in _HARDTANH_DEFAULTS)
                below = g.call_function(_aten.lt.Scalar, (x, -1.0))
                above = g.call_function(_aten.gt.Scalar, (x, 1.0))
                inner = g.call_function(_aten.where.self, (below, lo, x))
                new = g.call_function(_aten.where.self, (above, hi, inner))
        elif target in _CLAMPS:
            ilo, ihi = _CLAMPS[target]
            x = node.args[0]
            new = x
            with g.inserting_before(node):
                for i, name, op in ((ilo, "min", _aten.maximum.default),
                                    (ihi, "max", _aten.minimum.default)):
                    bound = _arg(node, i, name)
                    if bound is None:
                        continue
                    if not isinstance(bound, torch.fx.Node):
                        bound = g.call_function(_aten.full_like.default,
                                                (x, bound))
                    new = g.call_function(op, (new, bound))
        else:
            continue
        new.meta = dict(node.meta)
        node.replace_all_uses_with(new)
        g.erase_node(node)
        n += 1
    g.lint()
    gm.recompile()
    return n


def _hardtanh_bounds(node):
    lo, hi = _arg(node, 1, "min_val"), _arg(node, 2, "max_val")
    return (_HARDTANH_DEFAULTS[0] if lo is None else lo,
            _HARDTANH_DEFAULTS[1] if hi is None else hi)


def _key(args):
    return tuple((tuple(a.shape), a.dtype, str(a.device))
                 if torch.is_tensor(a) else ("value", repr(a)) for a in args)


class JaxKinks:
    """fn with jax's rules at kinks (module docstring). at(*args) gives
    the function to differentiate for arguments of the shapes, dtypes
    and devices of args (traced once per such key, outside any
    torch.func transform): the rewritten trace, which takes the same
    arguments (the non-tensor ones as they were at the trace), or fn
    itself where fn does not trace."""

    def __init__(self, fn):
        self.fn = fn
        self._cache = {}

    def at(self, *args):
        key = _key(args)
        if key not in self._cache:
            gm = _traced(self.fn, args)
            self._cache[key] = self.fn if gm is None else _call_tensors(gm)
        return self._cache[key]


def _call_tensors(gm):
    def run(*args):
        return gm(*[a for a in args if torch.is_tensor(a)])
    return run


def _traced(fn, args):
    from torch.fx.experimental.proxy_tensor import make_fx
    pos = [i for i, a in enumerate(args) if torch.is_tensor(a)]

    def tensors_only(*ts):
        full = list(args)
        for i, t in zip(pos, ts):
            full[i] = t
        return fn(*full)

    try:
        gm = make_fx(torch.func.functionalize(tensors_only),
                     tracing_mode="fake", _allow_non_fake_inputs=True)(
            *[args[i] for i in pos])
    except Exception:   # untraceable: torch's rules (module docstring)
        return None
    rewrite_kinks(gm)
    return gm
