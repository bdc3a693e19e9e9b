"""Whole-loop NLLS kernel for time-local (nonlinear) models, and its
plain-torch version.

Port of fabber_core_tpu/ops/fused_nlls.py. One hand-written CUDA kernel
for Hopper (csrc/fused_nlls.cu) replaces make_fused_nlls_loop: per
voxel, the whole damped Gauss-Newton loop (the reference's NLLS
optimizer, inference_nlls.cc:90-293) runs in registers —

  pass    model + latent-space Jacobian at a point, J'J (packed lower
          triangle), J'r and r'r over the unmasked samples;
  solve   (J'J + lam damp) delta = J'r by the unrolled Cholesky with the
          jitter retry (+1e-10 where a diagonal is not finite); damp = I
          (Levenberg) or diag(J'J) (Marquardt, --lm);
  accept  (accept()) a trial whose cost is finite and lower is taken,
          lam *= 0.1, else lam *= 10; the lane is done when lam passes
          1e10, an accepted step gains <= CFTOL of the cost, or a
          rejected trial at lam >= PLATEAU_LAMBDA sits within CFTOL of
          it —

then the posterior precision J'J/mse with the 1e-6 diagonal floor
(inference_nlls.cc:175-192) and its inverse.

Three modes (make_fused_nlls_loop's resume/posterior flags):
  fresh    (state=None, posterior=True): the one-pass form: J'J and J'r
           ride the carry, each step evaluates the model only at the
           trial point, whose r'r is the trial cost -> (params, cost,
           its, prec, cov);
  phase 1  (state=None, posterior=False): the same loop, capped by the
           engine -> (params, state [4,V] = lam, cost, done, its);
  resume   (state given): the two-pass form (the statistics at the
           current params, then the cost at the trial point) continuing
           the lambda ladder, cost and iteration count of `state` for at
           most `max_its` more steps, then one more pass for J'J and the
           posterior -> as fresh.
A lane's trajectory is its own, so phase 1 + resume gives the fresh
run's outputs (on the card bit for bit: inference/nlls.py's two-phase
straggler compaction).

Dropped TPU machinery: the edge-padded time axis with weight-0 rows, the
[TB,B] partial-sum planes, the voxel padding to the block and its VMEM
picker, the float32 0/1 masks standing in for bools (the plain version
and the kernel select with real bools: a lane whose trial is not finite
keeps its state, as the JAX package's generic route does) and the
tile-wide early exit (the kernel's threads leave their loops when their
lane is done; a done lane never commits, so each lane's outcome is the
same).

The kernel stages each block's [T, VB] data tile in shared memory once
(csrc/tile.cuh) where ops/_cuda.py tile_plan says it fits, and streams
the plane from global memory otherwise; the two forms agree bit for bit.

The model's functor is a hand-written one (kernel_model(), the
instances of csrc/fused_nlls.cu) or one generated from its time_signal
(models/kernelgen.py), whose library the engine builds (ops/_cuda.py
build_generated, kernel "nlls", with the source's -fmad=false) before it
launches. The wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
``fused_nlls_loop.launches`` counts kernel launches, ``resume_launches``,
``marquardt_launches``, ``staged_launches`` and ``generated_launches``
those in resume mode, with Marquardt damping, in the staged form and
with a generated functor, ``instance_launches`` those of a per-shape
instance (ops/_cuda.py build_instance "nl": a hand-written functor's
(kind, P) outside FABBER_NL_INSTANCES, built at its first launch). The
NLLS route takes kernel 8 where the JAX engine's picker does
(pick_nlls_block), on the card and on the CPU alike.
"""

import numpy as np
import torch

from . import smallmat as sm
from .fused_vb import (TRANSFORM_CODES, block_eval, check_plane,
                       generated_lib, nl_instantiated, signal_jac_fn,
                       time_index)

# The optimizer's constants (the JAX package's inference/nlls.py:62-98 =
# ops/fused_nlls.py:43-49; inference/nlls.py here imports them, and the
# kernel takes them by value): the lambda ladder, the posterior's
# diagonal floor, the relative cost-gain tolerance (scaled to float32
# cost sums, one decade above their noise at T ~ 100) and the lambda at
# which a rejected trial within CFTOL of the cost ends the lane.
LAMBDA_INIT = 1e-3
LAMBDA_GROW = 10.0
LAMBDA_SHRINK = 0.1
LAMBDA_MAX = 1e10
PREC_DIAG_FLOOR = 1e-6
CFTOL = 1e-5
PLATEAU_LAMBDA = 1.0

# csrc/fused_nlls.cu's Mode
MODE_FRESH, MODE_PHASE1, MODE_RESUME = 0, 1, 2


def accept(cost, tcost, lam, done):
    """One step's decision for every lane [V], the one copy the plain
    loops share (csrc/fused_nlls.cu writes it per thread): a trial whose
    cost is finite and lower is taken (lam *= LAMBDA_SHRINK), else lam
    *= LAMBDA_GROW; the lane is done past LAMBDA_MAX, at a relative gain
    <= CFTOL, or on a rejected plateau (lam >= PLATEAU_LAMBDA, the trial
    within CFTOL of the cost). Lanes done before the step keep their
    state. Returns (take, lam, done) after the step."""
    fin = torch.isfinite(tcost)
    better = (tcost < cost) & fin
    newl = torch.where(better, lam * LAMBDA_SHRINK, lam * LAMBDA_GROW)
    converged = better & (cost - tcost <= CFTOL * torch.clamp(
        tcost.abs(), min=1e-30))
    plateau = (~better) & fin & (lam >= PLATEAU_LAMBDA) & (
        tcost - cost <= CFTOL * torch.clamp(cost.abs(), min=1e-30))
    act = ~done
    return (act & better, torch.where(act, newl, lam),
            done | (act & ((newl > LAMBDA_MAX) | converged | plateau)))


def nlls_instantiated(kmodel):
    """True when the CUDA NLLS kernel is compiled for this model functor
    (a KernelModel, or None for a model without one): every (kind, P) of
    csrc/vb_device.cuh FABBER_NL_INSTANCES, asked of the built
    library."""
    if kmodel is None:
        return False
    from . import _cuda
    return _cuda.has_nlls_instance(kmodel.kind, kmodel.nparams)


# The JAX engine's gate for its NLLS kernel on a TPU (fabber_core_tpu/
# ops/fused_nlls.py n_nlls_rows, pick_nlls_block; the port's own copy):
# the TPU kernel's live float32 rows of a voxel tile against its VMEM
# budget at the time axis padded to 8 samples. The port's NLLS route gate
# takes kernel 8 where the JAX engine does (inference/nlls.py): P <= 42
# at T = 100, else the generic route.
def n_nlls_rows(p, tp):
    """Per-voxel live float32 rows of the JAX NLLS kernel: the data input,
    params and LM lanes, the [TB,B] partial sums, the evaluation's rows."""
    ntri = p * (p + 1) // 2
    tb = 8
    return (2 * tp + 2 * p + 2 * (p + 2 * p * p + 2) + p + 5
            + 3 * tb * (p + 1) + tb * (ntri + p + 1) + 10)


def pick_nlls_block(nvoxels, p, tp):
    """The JAX engine's voxel tile for kernel 8, (block, pad), or None
    where none fits its VMEM budget."""
    from .fused_loop import VMEM_BUDGET
    rows = n_nlls_rows(p, tp)
    for bb in (2048, 1024, 512, 256, 128):
        if rows * bb * 4 <= VMEM_BUDGET:
            return bb, (-nvoxels) % bb
    return None


def _tmask_host(tmask, nt):
    w = np.asarray(tmask, np.float64).reshape(-1)
    if w.shape != (nt,):
        raise ValueError(f"tmask has {w.size} values for {nt} timepoints")
    return w


def fused_nlls_loop_plain(time_signal_jac, transforms, params0, data,
                          tmask, max_its, marquardt=False, state=None,
                          posterior=True):
    """Plain torch, step for step the TPU kernel's arithmetic: params0
    [P,V] latent, data [T,V], tmask [T] host 0/1 timepoint weights,
    max_its the step budget (in resume mode the remaining one), state
    [4,V] (lam, cost, done, its) to resume from or None. Returns the
    module docstring's outputs for the mode."""
    if state is not None and not posterior:
        raise ValueError("resume mode always builds the posterior")
    dt, dev = params0.dtype, params0.device
    p, nv = params0.shape
    nt = data.shape[0]
    w_h = _tmask_host(tmask, nt)
    w = torch.as_tensor(w_h, dtype=dt, device=dev)[:, None]       # [T,1]
    data = data.to(dt)
    t = time_index(nt, dt, dev)
    tri = [(i, j) for i in range(p) for j in range(i + 1)]

    def stats_pass(x):
        """J'J [P,P,V], J'r [P,V] and r'r [V] at latent params x, with
        the weight folded into r once (w in {0,1})."""
        sig, jac = block_eval(time_signal_jac, transforms, x, t)
        d = data - sig
        r = w * d
        g = [[None] * p for _ in range(p)]
        for i, j in tri:
            g[i][j] = g[j][i] = torch.sum(w * jac[i] * jac[j], dim=0)
        jtj = torch.stack([torch.stack(row) for row in g])
        jtr = torch.stack([torch.sum(jac[a] * r, dim=0) for a in range(p)])
        return jtj, jtr, torch.sum(r * d, dim=0)

    def cost_at(x):
        sig, _ = block_eval(time_signal_jac, transforms, x, t)
        d = data - sig
        return torch.sum(w * d * d, dim=0)

    def solve_step(jtj, jtr, params, lam):
        damp = sm.diag_of(jtj) if marquardt else torch.ones_like(params)
        chol, _ = sm.cholesky_jittered(sm.add_diag(jtj, lam[None] * damp))
        return params + sm.solve_chol_vec(chol, jtr)

    if state is None:
        jtj, jtr, cost = stats_pass(params0)
        lam = torch.full((nv,), LAMBDA_INIT, dtype=dt, device=dev)
        done = torch.zeros(nv, dtype=torch.bool, device=dev)
        its = torch.zeros(nv, dtype=dt, device=dev)
    else:
        state = state.to(dt)
        lam, cost, done, its = state[0], state[1], state[2] > 0.5, state[3]
    params = params0
    it = 0
    while it < max_its and not bool(done.all()):
        if state is None:
            trial = solve_step(jtj, jtr, params, lam)
            tjtj, tjtr, tcost = stats_pass(trial)
        else:
            jtj, jtr, _ = stats_pass(params)
            trial = solve_step(jtj, jtr, params, lam)
            tcost = cost_at(trial)
        its = its + (~done).to(dt)
        take, lam, done = accept(cost, tcost, lam, done)
        params = torch.where(take[None], trial, params)
        cost = torch.where(take, tcost, cost)
        if state is None:
            jtj = torch.where(take[None, None], tjtj, jtj)
            jtr = torch.where(take[None], tjtr, jtr)
        it += 1

    if not posterior:
        return params, torch.stack([lam, cost, done.to(dt), its])
    if state is not None:
        jtj, _, _ = stats_pass(params)
    mse = cost / float(w_h.sum() - p)
    prec = jtj / mse[None, None]
    d = torch.maximum(sm.diag_of(prec),
                      torch.full_like(cost, PREC_DIAG_FLOOR)[None])
    for i in range(p):
        prec[i, i] = d[i]
    chol, _ = sm.cholesky_jittered(prec)
    return params, cost, its, prec, sm.inverse_from_chol(chol)


def fused_nlls_loop(model, transforms, params0, data, tmask, max_its,
                    marquardt=False, state=None, posterior=True,
                    functor=None, _vb=None):
    """The whole NLLS loop (see fused_nlls_loop_plain for the shapes and
    the modes). model: the forward model (signal_jac_fn(model) on the
    CPU, kernel_model() for the CUDA functor); functor: a
    models/kernelgen.py TimeLocalEval generated from the model's
    time_signal, whose kernel the card launches from
    functor.libs[("nlls", None)]. _vb: private, for the tests and
    chip_smoke.py: forces the kernel's form (0 streamed, > 0 staged in
    blocks of that many lanes; ops/_cuda.py launch_vb)."""
    if max_its < 0:
        raise ValueError("max_its must be >= 0")
    if state is not None and not posterior:
        raise ValueError("resume mode always builds the posterior")
    if params0.device.type == "cpu":
        return fused_nlls_loop_plain(signal_jac_fn(model), transforms,
                                     params0, data, tmask, max_its,
                                     marquardt, state, posterior)
    dev = params0.device
    p, nv = params0.shape
    nt = data.shape[0]
    if functor is None:
        km = model.kernel_model()
        if not nl_instantiated(km, None, "nlls"):
            raise ValueError(f"no CUDA NLLS kernel instantiation for model "
                             f"{getattr(model, 'name', model)} ({km})")
        npar = km.nparams
    else:
        npar = functor.nparams
    if len(transforms) != npar or p != npar:
        raise ValueError(f"{len(transforms)} transforms and {p} parameter "
                         f"rows for {npar} parameters")
    tcodes = [TRANSFORM_CODES[tr.code] for tr in transforms]
    check_plane(params0, "params0", (p, nv), dev)
    check_plane(data, "data", (nt, nv), dev)
    if state is not None:
        check_plane(state, "state", (4, nv), dev)
    w_h = _tmask_host(tmask, nt)
    w = torch.as_tensor(w_h, dtype=torch.float32).to(dev)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if posterior:
        outs = (out(p, nv), out(nv), out(nv), out(p, p, nv), out(p, p, nv),
                None)
        mode = MODE_RESUME if state is not None else MODE_FRESH
    else:
        outs = (out(p, nv), None, None, None, None, out(4, nv))
        mode = MODE_PHASE1
    consts = [LAMBDA_INIT, LAMBDA_GROW, LAMBDA_SHRINK, LAMBDA_MAX,
              PREC_DIAG_FLOOR, CFTOL, PLATEAU_LAMBDA]
    if nv:
        from . import _cuda
        vb = _cuda.launch_vb(nt, 1, _vb)
        dof = float(w_h.sum() - p)
        if functor is None:
            if _cuda.launch_nlls(km, tcodes, consts, mode, bool(marquardt),
                                 int(max_its), dof, params0, data, w, state,
                                 outs, vb):
                fused_nlls_loop.instance_launches += 1
        else:
            _cuda.launch_gen_nlls(
                generated_lib(functor, "nlls", None), tcodes, consts, mode,
                bool(marquardt), int(max_its), dof, params0, data, w, state,
                outs, vb)
            fused_nlls_loop.generated_launches += 1
        fused_nlls_loop.launches += 1
        if vb > 0:
            fused_nlls_loop.staged_launches += 1
        if mode == MODE_RESUME:
            fused_nlls_loop.resume_launches += 1
        if marquardt:
            fused_nlls_loop.marquardt_launches += 1
    if posterior:
        return outs[:5]
    return outs[0], outs[5]


fused_nlls_loop.launches = 0
fused_nlls_loop.resume_launches = 0
fused_nlls_loop.marquardt_launches = 0
fused_nlls_loop.staged_launches = 0
fused_nlls_loop.generated_launches = 0
fused_nlls_loop.instance_launches = 0
