"""Training-program construction tests."""

import numpy as np
import pytest

from phlash_tpu.training import build_training



def test_f32_step_graph_has_no_tensor_f64():
    """The default (f32-parameter) training step's traced graph must contain
    no non-scalar float64 intermediate: under the global x64 policy one bare
    jnp.zeros/jnp.array silently promotes a subgraph to f64.  Scalar f64s
    from optax/random internals are tolerated."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    chunks = rng.binomial(1, 0.05, size=(32, 320)).astype(np.int8)
    afs = rng.integers(10, 100, size=5).astype(np.int64)
    prog = build_training(
        chunks, afs, window_size=100, overlap=64, key=jax.random.PRNGKey(0),
        options=dict(num_particles=8, minibatch_size=2, niter=10,
                     kernel_backend="dense"),
    )
    jxp = jax.make_jaxpr(prog.step)(prog.state, jax.random.PRNGKey(1))

    offenders = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            for v in eqn.outvars:
                aval = getattr(v, "aval", None)
                if (
                    getattr(aval, "dtype", None) == jnp.float64
                    and np.prod(aval.shape, dtype=int) > 8
                ):
                    offenders.append((eqn.primitive.name, str(aval)))
            for p in eqn.params.values():
                for sub in p if isinstance(p, (list, tuple)) else [p]:
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr)

    walk(jxp.jaxpr)
    assert not offenders, f"f64 tensors in the f32 step graph: {offenders[:10]}"


def test_multi_step_equals_sequential_steps():
    """make_multi_step(step, k) must apply `step` to exactly the k keys
    jax.random.split(key, k), in order.  Verified with a deterministic
    key-consuming step (the real SVGD step cannot be compared at the
    value level: it chaotically amplifies f32 compile-variant rounding —
    even jit-vs-eager of the SAME step diverges ~0.5 after 3 steps,
    measured on an 8-particle toy cloud)."""
    import jax
    import jax.numpy as jnp

    from phlash_tpu.training import make_multi_step

    def fake_step(s, kk):
        return jax.tree.map(lambda a: 1.1 * a + jax.random.uniform(kk, a.shape), s)

    state = {"x": jnp.arange(6.0).reshape(2, 3), "y": jnp.ones(4)}
    key = jax.random.PRNGKey(7)
    s_seq = state
    for kk in jax.random.split(key, 3):
        s_seq = fake_step(s_seq, kk)
    s_multi = jax.jit(make_multi_step(fake_step, 3))(state, key)
    for a, b in zip(jax.tree.leaves(s_seq), jax.tree.leaves(s_multi)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_steps_per_call_default_resolution(monkeypatch):
    """Unspecified steps_per_call resolves to 1 on CPU and 10 on an
    accelerator backend (clamped to niter); an explicit value wins."""
    import jax

    rng = np.random.default_rng(0)
    chunks = rng.binomial(1, 0.05, size=(16, 192)).astype(np.int8)
    afs = rng.integers(10, 100, size=3).astype(np.int64)

    def build(**opts):
        return build_training(
            chunks, afs, window_size=100, overlap=64,
            key=jax.random.PRNGKey(0),
            options=dict(num_particles=4, minibatch_size=2,
                         kernel_backend="dense", **opts),
        )

    assert build(niter=20).steps_per_call == 1  # CPU default

    class FakeDev:
        platform = "gpu"

    monkeypatch.setattr("phlash_tpu.training.jax.devices", lambda: [FakeDev()])
    assert build(niter=20).steps_per_call == 10  # accelerator default
    assert build(niter=3).steps_per_call == 3  # clamped to niter
    assert build(niter=20, steps_per_call=2).steps_per_call == 2  # explicit


@pytest.mark.heavy  # compiles a scanned full SVGD step + two fit() graphs (~90 s)
def test_fit_steps_per_call_smoke():
    """steps_per_call plumbs through build_training; fit() with a
    non-dividing steps_per_call runs the strided loop, takes a partial
    final call landing exactly on niter, and returns particles."""
    import jax

    import phlash_tpu
    from phlash_tpu.data import RawContig

    rng = np.random.default_rng(1)
    chunks = rng.binomial(1, 0.05, size=(32, 320)).astype(np.int8)
    afs = rng.integers(10, 100, size=5).astype(np.int64)
    prog3 = build_training(
        chunks, afs, window_size=100, overlap=64, key=jax.random.PRNGKey(0),
        options=dict(num_particles=8, minibatch_size=2, niter=10,
                     kernel_backend="dense", steps_per_call=3),
    )
    assert prog3.steps_per_call == 3
    out = jax.jit(prog3.step)(prog3.state, jax.random.PRNGKey(7))
    flat = np.concatenate([np.ravel(x) for x in jax.tree.leaves(out.particles)])
    assert np.isfinite(flat).all()

    rng = np.random.default_rng(2)
    het = rng.binomial(1, 0.1, size=(1, 4000)).astype(np.int8)
    c = RawContig(het_matrix=het, afs=np.array([5]), window_size=100)
    # niter=10 with steps_per_call=4: calls advance 4+4+2 iterations.
    # save_every=1 checkpoints every call, so the final checkpoint's
    # recorded step pins that the run landed on exactly niter.
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        ckpt = f"{d}/s.npz"
        post = phlash_tpu.fit(
            [c], test_data=c, niter=10, steps_per_call=4, num_particles=4,
            overlap=20, chunk_size=200, progress=False, kernel_backend="dense",
            checkpoint_path=ckpt, save_every=1,
        )
        assert len(post) == 4
        from phlash_tpu.checkpoint import load_checkpoint
        from phlash_tpu.data import init_mcmc_data

        afs2, chunks2 = init_mcmc_data([c], 100, 20, 200, num_workers=1)
        tmpl = build_training(
            chunks2, afs2, window_size=100, overlap=20,
            key=jax.random.PRNGKey(0),
            options=dict(num_particles=4, kernel_backend="dense", niter=10),
        )
        back = load_checkpoint(ckpt, tmpl.state)
        assert back is not None and back.step == 10  # 4 + 4 + 2, not 12
