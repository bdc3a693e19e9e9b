"""Per-iteration fused VB kernel for time-local (nonlinear) models, the
in-model evaluator it shares with the whole-loop kernel, and the
plain-torch version of both.

Port of fabber_core_tpu/ops/fused_vb.py. One hand-written CUDA kernel
for Hopper (csrc/fused_vb_iter.cu) replaces make_fused_iteration: per
voxel, one VB iteration of white-noise VB for a model whose signal at
time t depends only on its parameters and t (exp/biexp, poly):

  pass A  model + latent-space Jacobian at the centre, per noise group
          J'Q_iJ and J'Q_i r;
  solve   prec = sum_i phi_i J'Q_iJ + diag(prior_prec), unrolled
          Cholesky (no jitter, as the TPU kernel), covariance, means;
          with lm_alpha (the lm detector's damping, the TPU kernel's
          with_lm branch), where alpha > 0 the means take the damped
          step centre + (Lambda + alpha diag Lambda)^-1 (sum_i phi_i
          J'Q_i r + pp (pm - centre));
  pass B  k = r + J (centre - means), per group k'Q_ik, and
          tr(Sigma J'Q_iJ) for the phi update (assembled outside);
  pass C  (need_f) the same quadratics at the new means, for F.

The kernel stages each block's data tile in shared memory where
ops/_cuda.py tile_plan says it fits (csrc/tile.cuh), else streams the
plane. The model's functor is a hand-written one (kernel_model(), the
instances of csrc/fused_vb_iter.cu) or one generated from its
time_signal (models/kernelgen.py), whose library the engine builds
(ops/_cuda.py build_generated, kernel "vb_iter") before it launches. The
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. ``fused_iteration.launches``
counts kernel launches (never plain calls), ``lm_launches`` those with
the LM branch, ``staged_launches`` those in the staged form,
``generated_launches`` those with a generated functor,
``instance_launches`` those of a per-shape instance (ops/_cuda.py
build_instance "nl"), ``coop_launches`` those of the cooperative form
(csrc/fused_vb_iter.cuh fused_vb_iter_coop_kernel: a per-shape or
generated unit past ops/_cuda.py rolled_loops' sizes, one warp per voxel
with its state in shared memory, up to kCoopMaxP).

block_eval is make_block_eval's counterpart: the model's analytic
time_signal_jac in model space times the per-parameter chain factor
d to_model / d latent, which matches jax.jvp of the JAX transforms
everywhere, their edges included (softplus is exactly 1 for x >= 10,
abs has slope +1 at 0, as jax's abs rule selects on x >= 0). The TPU
kernel's TB=8 time blocks, edge-padded time axis and 1024-voxel
padding are gone: the plain version runs the full [T,V] planes, the
kernel loops over the T samples exactly.
"""

import numpy as np
import torch

from . import smallmat as sm

# transform codes of csrc/vb_device.cuh (to_model / chain factor)
TRANSFORM_CODES = {"I": 0, "L": 1, "S": 2, "F": 3, "A": 4}


def kernel_instantiated(kmodel, nq):
    """True when the CUDA kernels are compiled for this model functor
    (a KernelModel, or None for a model without one) at nq noise
    groups. The list is csrc/vb_device.cuh's FABBER_NL_INSTANCES,
    asked of the built library (exp and biexp at Q = 1..4, exp with
    num-exps 3 and 4 and poly P = 1..4 at Q = 1, 2)."""
    if kmodel is None:
        return False
    from . import _cuda
    return _cuda.has_nl_instance(kmodel.kind, kmodel.nparams, nq)


def nl_instantiated(kmodel, nq, kernel):
    """True when kernel ("nl_loop", kernel 6, or "vb_iter", 7, at nq
    groups; "nlls", 8, nq None: ops/_cuda.py GEN_KERNELS' keys) can run this
    model functor (a KernelModel, or None for a model without one) on the
    card: the prebuilt library holds it (kernel_instantiated, and
    fused_nlls.py nlls_instantiated), or the kernel's per-shape unit can
    be built at the route's first launch (ops/_cuda.py build_instance
    "nl": any (P, Q) up to csrc/vb_device.cuh kWideMaxP, kWideMaxQ, kernel
    7 up to its kCoopMaxP, an exp sum at even P). Nothing is built
    here."""
    if kmodel is None:
        return False
    from . import _cuda
    prebuilt = (_cuda.has_nl_instance(kmodel.kind, kmodel.nparams, nq)
                if nq is not None
                else _cuda.has_nlls_instance(kmodel.kind, kmodel.nparams))
    return prebuilt or _cuda.instance_buildable(
        "nl", kmodel.nparams, nq or 1, kmodel.kind, kernel)


def signal_jac_fn(model):
    """The model's time_signal_jac; for a model with a time_signal
    alone, its forward-mode derivative per parameter (as
    make_block_eval's jax.jvp branch does), with jax's rules at kinks
    (models/kinks.py)."""
    tsj = getattr(model, "time_signal_jac", None)
    if tsj is not None:
        return tsj
    from ..models.kinks import JaxKinks
    kinks = JaxKinks(lambda *a: model.time_signal(list(a[:-1]), a[-1]))

    def jvp_jac(mrows, t):
        g = kinks.at(*mrows, t)
        jac = []
        for i, row in enumerate(mrows):
            def f(x, i=i):
                return g(*mrows[:i], x, *mrows[i + 1:], t)
            sig, d = torch.func.jvp(f, (row,), (torch.ones_like(row),))
            jac.append(d)
        return sig, jac
    return jvp_jac


def chain_factor(transform, x):
    """d to_model(x) / dx elementwise, as jax.jvp of the JAX transform
    gives it."""
    code = transform.code
    if code == "I":
        return torch.ones_like(x)
    if code == "L":
        return torch.exp(x)
    if code == "S":
        e = torch.exp(torch.clamp(x, max=10.0))
        return torch.where(x < 10.0, e / (1.0 + e), torch.ones_like(x))
    if code == "F":
        e = torch.exp(x)
        u = 1.0 + e
        return -e / (u * u)
    if code == "A":
        # jax's abs rule: slope +1 where x >= 0 (0 and -0 included)
        one = torch.ones_like(x)
        return torch.where(x >= 0.0, one, -one)
    raise ValueError(f"no chain factor for transform '{code}'")


def time_index(nt, dtype, device):
    """[T,1] 0-based sample index in the compute dtype."""
    return torch.arange(nt, dtype=dtype, device=device)[:, None]


def block_eval(time_signal_jac, transforms, latent, t):
    """Signal [T,V] and latent-space Jacobian [P,T,V] at latent means
    [P,V], from the model's time_signal_jac(model rows [1,V] list,
    t [T,1])."""
    rows = [latent[i:i + 1] for i in range(latent.shape[0])]
    mrows = [tr.to_model(r) for tr, r in zip(transforms, rows)]
    sig, jm = time_signal_jac(mrows, t)
    jac = torch.stack([(jm[i] * chain_factor(tr, rows[i])).expand(
        t.shape[0], latent.shape[1]) for i, tr in enumerate(transforms)])
    return sig.expand(t.shape[0], latent.shape[1]), jac


def block_evaluator(time_signal_jac, transforms, nt):
    """latent [P,V] -> (signal [T,V], latent-space Jacobian [P,T,V])
    from the model's time_signal_jac (block_eval over the T samples)."""
    def evaluator(latent):
        return block_eval(time_signal_jac, transforms, latent,
                          time_index(nt, latent.dtype, latent.device))
    return evaluator


def full_eval(fn, transforms, supp=None):
    """make_full_eval's counterpart (the whole-loop kernel's generic
    full-time mode): latent [P,V] -> (signal [T,V], latent-space
    Jacobian [P,T,V]) from fn(params [P][, supp [S]]) -> [T] (a model's
    data-free evaluate, models/kernelgen.py) vmapped over the voxel
    lanes. The model-space Jacobian comes from forward mode (one
    torch.func.jvp per parameter, as the TPU kernel's jax.linearize
    applies its linear map per basis tangent) with jax's rules at kinks
    (models/kinks.py), times the chain factors; supp [S,V] rides along
    per lane with no derivative taken through it."""
    from ..models.kinks import JaxKinks
    kinks = JaxKinks(fn)

    def evaluator(latent):
        p = latent.shape[0]
        rows = [latent[i] for i in range(p)]
        mrows = torch.stack([tr.to_model(r)
                             for tr, r in zip(transforms, rows)])
        one = torch.zeros(p, dtype=mrows.dtype, device=mrows.device)
        if supp is None:
            g = kinks.at(one)

            def f(m):
                return torch.func.vmap(g, in_dims=1, out_dims=1)(m)
        else:
            s = supp.to(latent.dtype)
            g = kinks.at(one, torch.zeros(s.shape[0], dtype=s.dtype,
                                          device=s.device))

            def f(m):
                return torch.func.vmap(g, in_dims=(1, 1), out_dims=1)(m, s)
        sig = f(mrows).to(latent.dtype)
        jac = []
        for i, tr in enumerate(transforms):
            basis = torch.zeros_like(mrows)
            basis[i] = 1.0
            _, d = torch.func.jvp(f, (mrows,), (basis,))
            jac.append(d.to(latent.dtype) * chain_factor(tr, rows[i])[None])
        return sig, torch.stack(jac)
    return evaluator


def group_masks(qmasks, dtype, device):
    """The [Q,T] group indicators (numpy or tensor) as a tensor."""
    return torch.as_tensor(np.asarray(qmasks), dtype=dtype, device=device)


def group_quadratics(jac, q, r=None):
    """Per noise group i: J'Q_iJ as a full symmetric [P,P,V] and, given
    a residual r [T,V], J'Q_i r [P,V] (else None)."""
    p = jac.shape[0]
    jtj, jtr = [], []
    for qi in range(q.shape[0]):
        w = q[qi][:, None]
        wj = [w * jac[i] for i in range(p)]
        g = [[None] * p for _ in range(p)]
        for i in range(p):
            for j in range(i + 1):
                g[i][j] = g[j][i] = torch.sum(wj[i] * jac[j], dim=0)
        jtj.append(torch.stack([torch.stack(row) for row in g]))
        jtr.append(None if r is None else torch.stack(
            [torch.sum(wj[a] * r, dim=0) for a in range(p)]))
    return jtj, jtr


def posterior_solve(jtj, jtr, phi, centre, prior_means, prior_prec,
                    jitter):
    """Eq 19/20 from the per-group quadratics: prec = sum_i phi_i
    J'Q_iJ + diag(pp), cov = prec^-1 (unrolled Cholesky, with the
    jitter retry when `jitter`), means = cov (sum_i phi_i (J'Q_i r +
    J'Q_iJ centre) + pp pm)."""
    p = centre.shape[0]
    prec = sum(phi[qi] * jtj[qi] for qi in range(len(jtj)))
    prec = sm.add_diag(prec, prior_prec)
    chol = sm.cholesky_jittered(prec)[0] if jitter \
        else sm.cholesky_planes(prec)
    cov = sm.inverse_from_chol(chol)
    rhs = []
    for a in range(p):
        v = 0.0
        for qi in range(len(jtj)):
            gi = jtr[qi][a]
            for j in range(p):
                gi = gi + jtj[qi][a, j] * centre[j]
            v = v + phi[qi] * gi
        rhs.append(v + prior_prec[a] * prior_means[a])
    return sm.matvec_planes(cov, torch.stack(rhs)), prec, cov, chol


def trace_terms(cov, jtj):
    """tr(Sigma J'Q_iJ) per group -> [Q,V]."""
    p = cov.shape[0]
    out = []
    for g in jtj:
        tr = 0.0
        for i in range(p):
            for j in range(p):
                tr = tr + cov[i, j] * g[i, j]
        out.append(tr)
    return torch.stack(out)


def f_quadratics(evaluator, means, data, q, cov):
    """(k'Q_ik, tr(Sigma J'Q_iJ)) [Q,V] at the given means: the free
    energy's quadratics (the TPU kernels' pass C). evaluator: the model
    as block_evaluator or full_eval make it."""
    sig, jac = evaluator(means)
    k = data - sig
    k2 = k * k
    kqk = torch.stack([torch.sum(q[qi][:, None] * k2, dim=0)
                       for qi in range(q.shape[0])])
    jtj, _ = group_quadratics(jac, q)
    return kqk, trace_terms(cov, jtj)


def fused_iteration_plain(time_signal_jac, transforms, centre, prior_means,
                          prior_prec, phi, data, qmasks, need_f,
                          lm_alpha=None):
    """Plain torch, one VB iteration (make_fused_iteration's run):
    centre/prior_means/prior_prec [P,V], phi [Q,V], data [T,V],
    qmasks [Q,T], lm_alpha [V] or None -> (means [P,V], prec [P,P,V],
    cov [P,P,V], noise_kqk, noise_tr, f_kqk, f_tr [Q,V]); the last two
    are zeros when need_f is False. k is formed explicitly, as the
    TPU kernel does from its staged J and r."""
    dt, dev = centre.dtype, centre.device
    q = group_masks(qmasks, dt, dev)
    data = data.to(dt)
    t = time_index(data.shape[0], dt, dev)
    sig, jac = block_eval(time_signal_jac, transforms, centre, t)
    r = data - sig
    jtj, jtr = group_quadratics(jac, q, r)
    means, prec, cov, _ = posterior_solve(jtj, jtr, phi, centre,
                                          prior_means, prior_prec, False)
    if lm_alpha is not None:
        # LM-damped update (noisemodel_white.cc:330-354)
        delta = []
        for a in range(centre.shape[0]):
            v = 0.0
            for qi in range(len(jtj)):
                v = v + phi[qi] * jtr[qi][a]
            delta.append(v + prior_prec[a] * (prior_means[a] - centre[a]))
        dchol = sm.cholesky_planes(sm.add_diag(
            prec, lm_alpha[None] * sm.diag_of(prec)))
        x = sm.solve_chol_vec(dchol, torch.stack(delta))
        means = torch.where((lm_alpha > 0.0)[None], centre + x, means)
    d = centre - means
    k = r
    for i in range(centre.shape[0]):
        k = k + jac[i] * d[i]
    k2 = k * k
    nkqk = torch.stack([torch.sum(q[qi][:, None] * k2, dim=0)
                        for qi in range(q.shape[0])])
    ntr = trace_terms(cov, jtj)
    if need_f:
        fkqk, ftr = f_quadratics(
            block_evaluator(time_signal_jac, transforms, data.shape[0]),
            means, data, q, cov)
    else:
        fkqk = torch.zeros_like(nkqk)
        ftr = torch.zeros_like(ntr)
    return means, prec, cov, nkqk, ntr, fkqk, ftr


# ---------------------------------------------------------------------------
# Kernel wrapper and the argument checks shared with ops/fused_loop_nl.py
# ---------------------------------------------------------------------------

def check_plane(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def generated_lib(functor, kernel, q):
    """The library of a TimeLocalEval's generated functor for kernel
    ("nl_loop", "vb_iter" or "nlls") at Q (None for "nlls"); raises
    where none was built."""
    lib = functor.libs.get((kernel, q))
    if lib is None:
        raise ValueError(
            f"no kernel built for this functor ({kernel!r} at Q={q}): "
            f"functor.libs[({kernel!r}, Q)] = ops/_cuda.py "
            "build_generated(...) (the engine builds it before it "
            "launches)")
    return lib


def functor_codes(functor, transforms):
    """The transform codes of a launch with a generated functor."""
    if len(transforms) != functor.nparams:
        raise ValueError(f"{len(transforms)} transforms for "
                         f"{functor.nparams} parameters")
    return [TRANSFORM_CODES[tr.code] for tr in transforms]


def kernel_args(model, transforms, nq, device, kernel):
    """(KernelModel, transform codes) for a launch of kernel ("nl_loop"
    or "vb_iter", nl_instantiated); raises when the kernel has no
    instantiation for it."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {device}")
    km = model.kernel_model()
    if not nl_instantiated(km, nq, kernel):
        raise ValueError(f"no CUDA kernel instantiation for model "
                         f"{getattr(model, 'name', model)} ({km}) at "
                         f"Q={nq}")
    if len(transforms) != km.nparams:
        raise ValueError(f"{len(transforms)} transforms for "
                         f"{km.nparams} parameters")
    return km, [TRANSFORM_CODES[tr.code] for tr in transforms]


def group_weights(qmasks, device):
    """[T,Q] float32 contiguous device copy of the [Q,T] indicators
    (numpy or a CPU tensor)."""
    q = torch.as_tensor(np.asarray(qmasks), dtype=torch.float32)
    return q.t().contiguous().to(device)


def iteration_form(model, nq, nt, functor=None, vb=None):
    """(cooperative, vb) of kernel 7's launch on the card for the model
    (or the generated functor) at nq groups and nt samples, as its unit
    says (ops/_cuda.py vb_iter_coop asks the per-shape instance or the
    functor's library): the cooperative form, which reads the plane where
    it is (vb 0, whatever vb forces), or the per-lane form at
    ops/_cuda.py launch_vb's vb (or the forced one)."""
    from . import _cuda
    if functor is not None:
        coop = _cuda.vb_iter_coop(None, functor.nparams, nq,
                                  generated_lib(functor, "vb_iter", nq))
    else:
        km = model.kernel_model()
        coop = _cuda.vb_iter_coop(km.kind, km.nparams, nq)
    return (True, 0) if coop else (False, _cuda.launch_vb(nt, nq, vb))


def fused_iteration(model, transforms, centre, prior_means, prior_prec,
                    phi, data, qmasks, need_f, lm_alpha=None, functor=None,
                    _vb=None):
    """One fused VB iteration (see fused_iteration_plain for the
    shapes). model: the forward model (signal_jac_fn(model) on the
    CPU, kernel_model() for the CUDA functor); transforms: per-parameter
    Transform objects; lm_alpha: the lm detector's [V] damping (the
    LM branch) or None; functor: a models/kernelgen.py TimeLocalEval
    generated from the model's time_signal, whose kernel the card
    launches from functor.libs[("vb_iter", Q)] (on the CPU the plain
    version differentiates the time_signal itself). _vb: private, for
    the tests and chip_smoke.py: forces the per-lane kernel's form (0
    streamed, > 0 staged in blocks of that many lanes; ops/_cuda.py
    launch_vb); the cooperative form has one (iteration_form)."""
    if centre.device.type == "cpu":
        return fused_iteration_plain(signal_jac_fn(model), transforms,
                                     centre, prior_means, prior_prec, phi,
                                     data, qmasks, need_f, lm_alpha)
    dev = centre.device
    p, nv = centre.shape
    nq = len(qmasks)
    if functor is None:
        km, tcodes = kernel_args(model, transforms, nq, dev, "vb_iter")
    else:
        tcodes = functor_codes(functor, transforms)
    nt = data.shape[0]
    for t, name, shape in ((centre, "centre", (p, nv)),
                           (prior_means, "prior_means", (p, nv)),
                           (prior_prec, "prior_prec", (p, nv)),
                           (phi, "phi", (nq, nv)), (data, "data", (nt, nv))):
        check_plane(t, name, shape, dev)
    if lm_alpha is not None:
        check_plane(lm_alpha, "lm_alpha", (nv,), dev)
    qw = group_weights(qmasks, dev)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (out(p, nv), out(p, p, nv), out(p, p, nv), out(nq, nv),
            out(nq, nv), out(nq, nv), out(nq, nv))
    if nv:
        from . import _cuda
        coop, vb = iteration_form(model, nq, nt, functor, _vb)
        if functor is None:
            if _cuda.launch_vb_iter(km, nq, tcodes, bool(need_f), centre,
                                    prior_means, prior_prec, phi, data, qw,
                                    lm_alpha, outs, vb):
                fused_iteration.instance_launches += 1
        else:
            _cuda.launch_gen_vb_iter(
                generated_lib(functor, "vb_iter", nq), tcodes, bool(need_f),
                centre, prior_means, prior_prec, phi, data, qw, lm_alpha,
                outs, vb)
            fused_iteration.generated_launches += 1
        fused_iteration.launches += 1
        if lm_alpha is not None:
            fused_iteration.lm_launches += 1
        if vb > 0:
            fused_iteration.staged_launches += 1
        if coop:
            fused_iteration.coop_launches += 1
    return outs


fused_iteration.launches = 0
fused_iteration.lm_launches = 0
fused_iteration.staged_launches = 0
fused_iteration.generated_launches = 0
fused_iteration.instance_launches = 0
fused_iteration.coop_launches = 0
