"""Cross-package parity: phlash_tpu vs. the ACTUAL reference implementation.

Everything else in this repo validates against self-built oracles (the dense
f64 backend, the scan kernel, quadrature).  This harness closes the remaining
gap: it imports the reference's pure-Python modules from
/root/reference/src/phlash (hmm.py, transition.py, size_history.py, params.py,
model.py, afs.py — no CUDA, no blackjax required) and asserts, at float64 on
identical inputs, that both packages compute the same numbers.  A convention
slip shared by all three home-grown backends (e.g. in PSMCParams.from_dm)
would be invisible to intra-repo cross-validation but is caught here.

The reference's heavy dependencies (loguru, demes, msprime, jax_dataclasses)
are not installed in this image.  The pure-math modules only touch them at
import time (a logger object, type annotations) or inside demes/msprime
interop methods this harness never calls, so minimal stubs are installed
before import.  The reference package __init__ (which pulls pysam/blackjax
via data.py/mcmc.py) is bypassed by registering a namespace-only ``phlash``
package pointing at the reference source tree.

Checks (tolerance structure per /root/reference/tests/test_gpu.py:45-66,
tightened to f64):

  1. transition_matrix(dm) — reference transition.py:37-85
  2. SizeHistory.ect / .pi / .etbl(n) / .surv / .R — size_history.py
  3. PSMCParams.from_dm, all 7 fields — params.py:32-55
  4. matvec_smc structure product — hmm.py:52-65
  5. psmc_ll log-likelihood AND filtered state, incl. missing data — hmm.py:68-82
  6. MCMCParams.from_linear -> to_dm roundtrip (t grid, expanded c, rho) — params.py:68-123
  7. log_prior and the full composite log_density (warmup-pi trick + HMM +
     AFS with BWS/fold transforms) and its GRADIENT wrt MCMCParams — model.py.
     The gradient is checked autodiff-vs-autodiff on the no-AFS composite and
     by finite differences of the reference's value on the full composite,
     because the reference's own AFS-term gradient is NaN (a jnp.where/expm1
     autodiff trap in its exp_integral t=inf branch — see the inline note)
  8. afs transforms (fold/project/bws) — afs.py

Run standalone:   JAX_PLATFORMS=cpu python tools/ref_parity.py
From pytest:      tests/test_ref_parity.py runs this in a subprocess.

Exit code 0 = full parity.  Prints one line per check.
"""

from __future__ import annotations

import importlib
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF_SRC = os.environ.get("PHLASH_REF_SRC", "/root/reference/src")

# ---------------------------------------------------------------------------
# dependency stubs (must precede any reference import)
# ---------------------------------------------------------------------------


def _stub_module(name: str) -> types.ModuleType:
    """A module whose every attribute resolves to a fresh dummy class.

    Good enough for type annotations like ``demes.Graph`` that the reference
    evaluates at import time but this harness never instantiates.
    """
    mod = types.ModuleType(name)
    mod.__getattr__ = lambda attr: type(attr, (), {})  # PEP 562
    return mod


class _NopLogger:
    def __getattr__(self, _name):
        return lambda *a, **k: None


def _make_jdc_stub() -> types.ModuleType:
    """Minimal jax_dataclasses: pytree_dataclass + Static[...] marker.

    The reference uses exactly two symbols (params.py:58-66): the decorator
    and the Static annotation.  Static fields become pytree aux data.
    """
    import dataclasses

    import jax

    jdc = types.ModuleType("jax_dataclasses")

    class Static:
        def __class_getitem__(cls, _item):
            return cls

    def pytree_dataclass(cls):
        cls = dataclasses.dataclass(cls)
        anns = cls.__annotations__
        static = [k for k, v in anns.items() if v is Static]
        data = [k for k in anns if k not in static]

        def flatten(obj):
            return (
                tuple(getattr(obj, k) for k in data),
                tuple(getattr(obj, k) for k in static),
            )

        def unflatten(aux, children):
            kw = dict(zip(data, children))
            kw.update(zip(static, aux))
            return cls(**kw)

        jax.tree_util.register_pytree_node(cls, flatten, unflatten)
        return cls

    jdc.Static = Static
    jdc.pytree_dataclass = pytree_dataclass
    return jdc


def import_reference():
    """Import the reference's pure modules; returns a namespace object."""
    for name in ("demes", "msprime", "stdpopsim", "tszip", "intervaltree"):
        sys.modules.setdefault(name, _stub_module(name))
    if "loguru" not in sys.modules:
        loguru = types.ModuleType("loguru")
        loguru.logger = _NopLogger()
        sys.modules["loguru"] = loguru
    sys.modules.setdefault("jax_dataclasses", _make_jdc_stub())

    # namespace package that skips the reference __init__.py (which imports
    # data/mcmc and with them pysam/blackjax)
    if "phlash" not in sys.modules:
        pkg = types.ModuleType("phlash")
        pkg.__path__ = [os.path.join(REF_SRC, "phlash")]
        sys.modules["phlash"] = pkg

    ns = types.SimpleNamespace()
    for sub in ("util", "jax_ppoly", "size_history", "transition", "params", "hmm", "model", "afs"):
        setattr(ns, sub, importlib.import_module(f"phlash.{sub}"))
    return ns


# ---------------------------------------------------------------------------
# parity checks
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = np.maximum(np.abs(b), 1e-300)
    return float(np.max(np.abs(a - b) / denom))


def main() -> int:
    # f64 host math by design; pin the platform in-process
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    ref = import_reference()

    import phlash_tpu.afs as our_afs
    import phlash_tpu.hmm as our_hmm
    import phlash_tpu.model as our_model
    import phlash_tpu.transition as our_transition
    from phlash_tpu.params import MCMCParams as OurMCMCParams
    from phlash_tpu.params import PSMCParams as OurPSMCParams
    from phlash_tpu.size_history import DemographicModel as OurDM
    from phlash_tpu.size_history import SizeHistory as OurSH

    failures: list[str] = []

    def check(name: str, rel: float, tol: float):
        ok = np.isfinite(rel) and rel <= tol  # NaN/inf is a failure, never a pass
        status = "ok" if ok else "FAIL"
        print(f"{name}: maxrel {rel:.3e} (tol {tol:.0e}) {status}")
        if not ok:
            failures.append(name)

    rng = np.random.default_rng(0)

    # shared model: non-trivial sawtooth-ish size history, f64 everywhere
    t = np.concatenate([[0.0], np.geomspace(1e-3, 15.0, 15)])
    c = np.exp(rng.normal(0.0, 0.5, size=16))
    theta, rho = 1e-2, 1.5e-2
    our_dm = OurDM(eta=OurSH(t=jnp.asarray(t), c=jnp.asarray(c)), theta=theta, rho=rho)
    ref_dm = ref.size_history.DemographicModel(
        eta=ref.size_history.SizeHistory(t=jnp.asarray(t), c=jnp.asarray(c)),
        theta=theta,
        rho=rho,
    )

    # 1. transition matrix.  Tolerance note: the two packages compute e^Q
    # differently — the reference's absorption is 1 - p00 - p01
    # (/root/reference/src/phlash/transition.py:28-31), which cancels
    # catastrophically for small absorption probabilities (up to ~1e6
    # RELATIVE error on those entries even at f64 — see the adjudication
    # below); phlash_tpu's _expQ2 is a reformulation whose guard thresholds
    # target float32, giving a uniform ~1e-7 relative bound everywhere (in
    # f64 as in f32, by design — f32 is the production dtype).  The ~1e-7
    # package-to-package disagreement is therefore expected and bounded.
    A_ours = our_transition.transition_matrix(our_dm)
    A_ref = ref.transition.transition_matrix(ref_dm)
    check("transition_matrix", _rel(A_ours, A_ref), 1e-6)

    # expQ adjudication against a 50-digit mpmath evaluation of the closed
    # form (e^Q for Q = [[-r, r, 0], [c, -c*n, c*(n-1)], [0, 0, 0]]).
    # scipy.linalg.expm is NOT a usable oracle here: its error is absolute
    # at the matrix scale, so the ~1e-20 absorption entries carry no
    # relative accuracy from it.  At 50 digits the reference's own
    # cancellation-prone 1 - p00 - p01 form is exact.
    import mpmath as mp

    def expq_true(r_, c_, n_):
        with mp.workdps(50):
            r_, c_ = mp.mpf(r_), mp.mpf(c_)
            u = mp.sqrt((c_ * n_) ** 2 - 2 * c_ * (n_ - 2) * r_ + r_**2) / 2
            v = (r_ + c_ * n_) / 2
            w = (r_ - c_ * n_) / 2
            t1 = (mp.e ** (u - v) + mp.e ** (-(u + v))) / 2
            t2 = (mp.e ** (u - v) - mp.e ** (-(u + v))) / (2 * u)
            p00, p01 = t1 - w * t2, r_ * t2
            p10, p11 = c_ * t2, t1 + w * t2
            rows = [
                [p00, p01, 1 - p00 - p01],
                [p10, p11, 1 - p10 - p11],
                [mp.mpf(0), mp.mpf(0), mp.mpf(1)],
            ]
            return np.array([[float(x) for x in row] for row in rows])

    def expq2_full(r_, c_, n_):
        "The cancellation-free block form transition_matrix actually uses."
        P2, p02, p12 = our_transition._expQ2(jnp.float64(r_), jnp.float64(c_), n_)
        P2 = np.asarray(P2)
        return np.array(
            [
                [P2[0, 0], P2[0, 1], float(p02)],
                [P2[1, 0], P2[1, 1], float(p12)],
                [0.0, 0.0, 1.0],
            ]
        )

    n_pair = 2
    worst_ours, worst_ref = 0.0, 0.0
    for r_ in (1e-8, 1e-4, 1e-2, 0.5, 3.0):
        for c_ in (1e-6, 1e-2, 1.0, 20.0):
            P_true = expq_true(r_, c_, n_pair)
            P_ours = expq2_full(r_, c_, n_pair)
            P_ref = np.asarray(ref.transition._expQ(jnp.float64(r_), jnp.float64(c_), n_pair))
            worst_ours = max(worst_ours, _rel(P_ours, P_true))
            worst_ref = max(worst_ref, _rel(P_ref, P_true))
    print(f"expQ vs 50-digit truth: ours maxrel {worst_ours:.3e}, reference maxrel {worst_ref:.3e}")
    check("expQ_no_worse_than_reference", worst_ours / max(worst_ref, 1e-300), 1.0)
    # ~1e-7: _expQ2's branch thresholds are tuned for the production f32
    # dtype, bounding relative error near f32 eps uniformly (the reference's
    # form is exact on easy entries but loses up to 6 ORDERS on hard ones)
    check("expQ_vs_truth", worst_ours, 1e-6)

    # 2. coalescent summaries
    check("SizeHistory.ect", _rel(our_dm.eta.ect(), ref_dm.eta.ect()), 1e-9)
    check("SizeHistory.pi", _rel(our_dm.eta.pi, ref_dm.eta.pi), 1e-9)
    # n=100 covers BASELINE config 4 (50 diploids -> n=100 joint AFS)
    for n in (5, 10, 26, 50, 100):
        check(f"SizeHistory.etbl(n={n})", _rel(our_dm.eta.etbl(n), ref_dm.eta.etbl(n)), 1e-8)
    check("SizeHistory.surv", _rel(our_dm.eta.surv(), ref_dm.eta.surv()), 1e-9)

    # 3. PSMCParams.from_dm — the compression convention
    pp_ours = OurPSMCParams.from_dm(our_dm)
    pp_ref = ref.params.PSMCParams.from_dm(ref_dm)
    for field in pp_ref._fields:
        # b (the transition subdiagonal) inherits the reference's expQ
        # cancellation noise (see the transition_matrix note above)
        tol = 1e-6 if field == "b" else 1e-8
        check(f"PSMCParams.{field}", _rel(getattr(pp_ours, field), getattr(pp_ref, field)), tol)

    # use the REFERENCE pp on both sides below so HMM checks isolate the
    # forward algorithm itself from any from_dm difference
    pp64 = ref.params.PSMCParams(*(jnp.asarray(a, dtype=jnp.float64) for a in pp_ref))
    pp64_ours = OurPSMCParams(*pp64)

    # 4. matvec structure product
    v = jnp.asarray(rng.dirichlet(np.ones(16)))
    check("matvec_smc", _rel(our_hmm.matvec_smc(v, pp64_ours), ref.hmm.matvec_smc(v, pp64)), 1e-12)

    # 5. forward algorithm: ll + filtered state, with missing data
    L = 3000
    obs = rng.binomial(1, 0.1, size=L).astype(np.int8)
    obs[500:700] = -1
    alpha_ref, ll_ref = ref.hmm.psmc_ll(pp64, jnp.asarray(obs))
    alpha_ours, ll_ours = our_hmm.psmc_ll(pp64_ours, jnp.asarray(obs))
    check("psmc_ll.ll", _rel(ll_ours, ll_ref), 1e-10)
    check("psmc_ll.filtered_state", _rel(alpha_ours, alpha_ref), 1e-9)

    # 6. MCMCParams transforms
    c0 = jnp.ones(15, dtype=jnp.float64)
    kw = dict(pattern="14*1+1*2", t1=1e-4, tM=15.0, c=c0, theta=theta, rho=rho, alpha=0.5, beta=1e-4)
    mcp_ours = OurMCMCParams.from_linear(**kw)
    mcp_ref = ref.params.MCMCParams.from_linear(**kw)
    check("MCMCParams.t_tr", _rel(mcp_ours.t_tr, mcp_ref.t_tr), 1e-12)
    check("MCMCParams.c_tr", _rel(mcp_ours.c_tr, mcp_ref.c_tr), 1e-12)
    check("MCMCParams.rho_over_theta_tr", _rel(mcp_ours.rho_over_theta_tr, mcp_ref.rho_over_theta_tr), 1e-12)
    dm_ours = mcp_ours.to_dm()
    dm_ref = mcp_ref.to_dm()
    check("to_dm.t", _rel(dm_ours.eta.t, dm_ref.eta.t), 1e-12)
    check("to_dm.c", _rel(dm_ours.eta.c, dm_ref.eta.c), 1e-12)
    check("to_dm.rho", _rel(dm_ours.rho, dm_ref.rho), 1e-12)

    # perturb the trainables so gradients are taken somewhere generic
    import dataclasses as _dc

    eps = rng.normal(0, 0.1, size=15)
    mcp_ours = _dc.replace(mcp_ours, c_tr=mcp_ours.c_tr + eps, rho_over_theta_tr=mcp_ours.rho_over_theta_tr + 0.3)
    mcp_ref = _dc.replace(mcp_ref, c_tr=mcp_ref.c_tr + eps, rho_over_theta_tr=mcp_ref.rho_over_theta_tr + 0.3)

    # 7. composite log-density + gradient (the full training objective)
    S, overlap, chunk = 4, 200, 1200
    data = rng.binomial(1, 0.08, size=(8, overlap + chunk)).astype(np.int8)
    data[2, 300:400] = -1
    warmup = jnp.asarray(data[:S, :overlap])
    inds = jnp.arange(S)
    n_samp = 10
    afs = jnp.asarray(rng.integers(100, 10_000, size=n_samp - 1), dtype=jnp.int64)
    T1 = our_afs.fold_transform(n_samp)
    T = jnp.asarray(our_afs.bws_transform(T1 @ np.asarray(afs)) @ T1, dtype=jnp.float64)
    cw = jnp.array([1.0, 2.5, 1.0], dtype=jnp.float64)

    kern_ref = ref.hmm.PureJaxPSMCKernel(M=16, data=data, double_precision=True)
    kern_ours = our_hmm.PureXLAKernel(M=16, data=data, double_precision=True)

    check("log_prior", _rel(our_model.log_prior(mcp_ours), ref.model.log_prior(mcp_ref)), 1e-10)

    # prior + HMM only: must match at near-f64 accuracy
    ld_ref0 = ref.model.log_density(mcp_ref, c=cw, inds=inds, warmup=warmup, kern=kern_ref, afs=None)
    ld_ours0 = our_model.log_density(mcp_ours, c=cw, inds=inds, warmup=warmup, kern=kern_ours, afs=None)
    check("log_density(no_afs)", _rel(ld_ours0, ld_ref0), 1e-10)

    # full composite: phlash_tpu evaluates the AFS xlogy term in float32 BY
    # DESIGN (f32 is exact for realistic AFS counts' purposes and keeps the
    # graph free of f64 — model.py comment),
    # so the comparison tolerance is f32 epsilon scaled by the AFS share
    ld_ref = ref.model.log_density(mcp_ref, c=cw, inds=inds, warmup=warmup, kern=kern_ref, afs=afs, afs_transform=T)
    ld_ours = our_model.log_density(mcp_ours, c=cw, inds=inds, warmup=warmup, kern=kern_ours, afs=afs, afs_transform=T)
    check("log_density", _rel(ld_ours, ld_ref), 2e-5)

    # gradient parity.  The reference's own autodiff gradient of the FULL
    # composite is NaN in c_tr/t_tr: its exp_integral takes the t=inf branch
    # through a jnp.where (/root/reference/src/phlash/jax_ppoly.py:79-84),
    # and the unselected branch's d/da expm1(-a*(inf - x)) = 0 * -inf = NaN
    # leaks through where's VJP, poisoning every etjj/etbl cotangent
    # (reproduce: jax.grad(lambda c: SizeHistory(t, c).etjj(10).sum())).
    # phlash_tpu's exp_integral is NaN-safe by construction (ppoly.py), so
    # the checks are structured as:
    #   (a) autodiff-vs-autodiff parity on the no-AFS composite, where both
    #       packages' gradients are finite;
    #   (b) our full-composite gradient adjudicated against central finite
    #       differences of the REFERENCE's value function (which is finite
    #       and already matched above) — proving ours is the true gradient
    #       of the reference's objective where the reference's own autodiff
    #       cannot produce one.
    g_ref0 = jax.grad(lambda m: ref.model.log_density(m, c=cw, inds=inds, warmup=warmup, kern=kern_ref, afs=None))(mcp_ref)
    g_ours0 = jax.grad(lambda m: our_model.log_density(m, c=cw, inds=inds, warmup=warmup, kern=kern_ours, afs=None))(mcp_ours)
    # tolerance: both sides accumulate a 5600-site f64 scan in different
    # summation orders; ~1e-8 relative on the gradient is the observed
    # floor of that reordering, not a semantic difference
    check("grad(log_density no_afs).c_tr", _rel(g_ours0.c_tr, g_ref0.c_tr), 1e-7)
    check("grad(log_density no_afs).t_tr", _rel(g_ours0.t_tr, g_ref0.t_tr), 1e-7)
    check(
        "grad(log_density no_afs).rho_over_theta_tr",
        _rel(g_ours0.rho_over_theta_tr, g_ref0.rho_over_theta_tr),
        1e-7,
    )

    g_ref_full = jax.grad(lambda m: ref.model.log_density(m, c=cw, inds=inds, warmup=warmup, kern=kern_ref, afs=afs, afs_transform=T))(mcp_ref)
    n_nan = int(sum(np.isnan(np.asarray(leaf)).sum() for leaf in (g_ref_full.c_tr, g_ref_full.t_tr)))
    print(f"reference full-composite autodiff gradient: {n_nan} NaN entries "
          "in c_tr/t_tr (the known where/expm1 trap; phlash_tpu's is finite)")
    if n_nan == 0:
        failures.append("expected_reference_nan_gradient_absent")

    g_ours = jax.grad(lambda m: our_model.log_density(m, c=cw, inds=inds, warmup=warmup, kern=kern_ours, afs=afs, afs_transform=T))(mcp_ours)
    if not all(np.isfinite(np.asarray(leaf)).all() for leaf in (g_ours.c_tr, g_ours.t_tr, g_ours.rho_over_theta_tr)):
        failures.append("our_full_gradient_not_finite")

    def ref_f(mcp):
        return float(ref.model.log_density(mcp, c=cw, inds=inds, warmup=warmup, kern=kern_ref, afs=afs, afs_transform=T))

    import dataclasses as _dc2

    fd_rng = np.random.default_rng(42)
    h = 1e-5
    worst_fd = 0.0
    for _ in range(3):
        dc = fd_rng.normal(0, 1, size=15)
        dt = fd_rng.normal(0, 1, size=2)
        dr = fd_rng.normal()

        def shifted(s):
            return _dc2.replace(
                mcp_ref,
                c_tr=mcp_ref.c_tr + s * h * dc,
                t_tr=mcp_ref.t_tr + s * h * dt,
                rho_over_theta_tr=mcp_ref.rho_over_theta_tr + s * h * dr,
            )

        fd = (ref_f(shifted(+1)) - ref_f(shifted(-1))) / (2 * h)
        ad = float(
            jnp.dot(g_ours.c_tr, jnp.asarray(dc))
            + jnp.dot(g_ours.t_tr, jnp.asarray(dt))
            + g_ours.rho_over_theta_tr * dr
        )
        worst_fd = max(worst_fd, abs(ad - fd) / max(abs(fd), 1e-300))
    # FD floor: the objective's third derivative along random directions is
    # large (HMM log-likelihood curvature), so central differences at
    # h=1e-5 carry ~1e-4 relative truncation error (measured ~1.4e-4);
    # the check certifies 3-digit agreement, which a wrong gradient
    # (sign, scale, missing term) cannot produce
    check("grad(log_density full) vs reference-value FD", worst_fd, 1e-3)

    # 8. afs transform matrices
    for n in (6, 11):
        check(f"fold_transform(n={n})", _rel(our_afs.fold_transform(n), ref.afs.fold_transform(n)), 1e-12)
        check(f"project_transform({n}->5)", _rel(our_afs.project_transform(n, 5), ref.afs.project_transform(n, 5)), 1e-12)
    a_ex = np.asarray(rng.integers(1, 10_000, size=25), dtype=np.int64)
    check("bws_transform", _rel(our_afs.bws_transform(a_ex), ref.afs.bws_transform(a_ex)), 1e-12)

    # 9. SVGD sampler-update parity vs the blackjax semantics the reference
    # runs (/root/reference/src/phlash/mcmc.py:178-199: blackjax.svgd with the
    # default rbf kernel + median heuristic, coupled to optax.amsgrad).
    # blackjax itself is not installable here, so the other side of the check
    # is tools/vendored_svgd.py — an independent transcription of blackjax
    # 1.2.5's vi/svgd.py in blackjax's own structural form (pairwise nested
    # vmap + value_and_grad of the scalar kernel), deliberately shaped
    # nothing like phlash_tpu.svgd's vectorized matmul form.  Agreement to
    # f64 roundoff across an amsgrad-coupled trajectory is therefore evidence
    # about the update *semantics* (bandwidth convention, direction, sign,
    # normalization, optimizer coupling), not shared code.  Known deliberate
    # deviations of phlash_tpu.svgd, all inert on this check's inputs:
    # a non-finite-gradient zeroing guard and a 1e-12 bandwidth floor.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import optax
    import vendored_svgd
    from jax.flatten_util import ravel_pytree

    from phlash_tpu.svgd import SVGD, median_bandwidth

    z0, unravel = ravel_pytree(mcp_ours)
    D = z0.size
    P = 24
    svgd_rng = np.random.default_rng(7)
    particles = jax.vmap(unravel)(
        jnp.asarray(z0)[None, :] + 0.25 * jnp.asarray(svgd_rng.normal(size=(P, D)))
    )
    # synthetic smooth target: correlated Gaussian in the raveled coordinates.
    # Gradients enter the SVGD update only as inputs, and gradient parity on
    # the real objective is established in §7 — this isolates the sampler.
    Wm = svgd_rng.normal(size=(D, D)) / np.sqrt(D)
    A_quad = jnp.asarray(Wm @ Wm.T + np.eye(D))
    z_target = jnp.asarray(z0 + 0.5 * svgd_rng.normal(size=D))

    def logp(p):
        dz = ravel_pytree(p)[0] - z_target
        return -0.5 * dz @ A_quad @ dz

    # bandwidth convention, checked directly on one particle cloud
    flat = jax.vmap(lambda p: ravel_pytree(p)[0])(particles)
    sq = jnp.sum((flat[:, None, :] - flat[None, :, :]) ** 2, -1)
    h_ours = median_bandwidth(sq, P)
    h_vend = vendored_svgd.median_heuristic({}, particles)["length_scale"]
    check("svgd median bandwidth", _rel(h_ours, h_vend), 1e-13)
    h_alt = float(jnp.median(jnp.sqrt(sq[jnp.tril_indices(P, -1)])) ** 2 / jnp.log(P + 1.0))
    print(
        f"svgd bandwidth convention: log(P) adopted; log(P+1) would scale h by "
        f"{h_alt / float(h_ours):.6f} (P={P}; {np.log(500) / np.log(501):.6f} at the "
        "production P=500) — below any posterior-level tolerance"
    )

    opt_v = optax.amsgrad(learning_rate=0.1)
    opt_p = optax.amsgrad(learning_rate=0.1)
    vend = vendored_svgd.svgd(jax.grad(logp), opt_v)
    ours_svgd = SVGD(jax.grad(logp), opt_p)
    state_v = vend.init(particles)
    state_p = ours_svgd.init(particles)

    step_v = jax.jit(vend.step)
    step_p = jax.jit(ours_svgd.step)
    worst_traj = 0.0
    for it in range(20):
        state_v = step_v(state_v)
        state_p = step_p(state_p)
        fv = jax.vmap(lambda p: ravel_pytree(p)[0])(state_v.particles)
        fp = jax.vmap(lambda p: ravel_pytree(p)[0])(state_p.particles)
        r = _rel(fp, fv)
        if it == 0:
            check("svgd update (1 amsgrad-coupled step)", r, 1e-11)
        worst_traj = max(worst_traj, r)
    # 20 amsgrad-coupled steps: the two formulations accumulate f64
    # reordering differently (pairwise-mean vs matmul) and amsgrad's
    # sqrt(v)+eps division amplifies it; ~2.5e-10 worst observed.  A wrong
    # bandwidth convention / sign / normalization would show as O(1).
    check("svgd trajectory (20 steps, worst)", worst_traj, 5e-9)

    if failures:
        print(f"PARITY FAIL: {failures}")
        return 1
    print("PARITY PASS: phlash_tpu matches the reference implementation at f64")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
