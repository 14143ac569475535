"""Batched-f64-eigh platform-bug regression (root-caused r5, 2026-08-20).

An accelerator backend's emulated-f64 eigh (on the platform this engine
was first built for) returned ALL-NaN eigenpairs for the
fourth matrix below when the four were decomposed as one batched (4,4,4)
call — while the identical matrix decomposed fine unbatched (eigenvalue
gaps ~0.02: well-conditioned, NOT a degeneracy case). The matrices are
the exact symmetrized-Q inputs from two adam steps of a stacked 4-locus
GTR+G4 fit, captured on that backend. ``models.base._eigh_f64_seq``
(sequential_vmap) sidesteps the batched kernel; these tests pin (a) the
sequential lowering stays correct under vmap on any backend and (b) the
engine path that hit the bug (vmapped per-locus model builds) yields
finite P matrices and logLs for these parameters.

On CPU the batched kernel is healthy, so this suite guards the FIX's
correctness here and the BUG's absence on-chip (bench/appbench exercise
the same path on hardware).
"""
import jax
import jax.numpy as jnp
import numpy as np

from phylo_utils_tpu.models.base import _eigh_f64_seq, eigen_reversible

# exact f64 values captured from the failing fit step (see module docs)
BAD_B = np.array([
    [[-0.9882294750103569, 0.3475068043794529, 0.330989820967611,
      0.34842701147592425],
     [0.3475068043794529, -1.015175008799778, 0.31857400688482773,
      0.3353567140986371],
     [0.330989820967611, 0.31857400688482773, -0.982045045665795,
      0.31884025084380685],
     [0.34842701147592425, 0.3353567140986371, 0.31884025084380685,
      -1.0154556196633422]],
    [[-1.009932509318193, 0.31594227795528873, 0.33772865468992386,
      0.32441428330323396],
     [0.31594227795528873, -1.0093959865446038, 0.34381159076436507,
      0.3446204536372548],
     [0.33772865468992386, 0.34381159076436507, -0.997171675490625,
      0.3333712200362067],
     [0.32441428330323396, 0.3446204536372548, 0.3333712200362067,
      -0.9845278011521259]],
], dtype=np.float64)


def test_sequential_eigh_matches_unbatched():
    b = jnp.asarray(np.stack([BAD_B[0], BAD_B[1], BAD_B[0], BAD_B[1]]))
    w_seq, u_seq = jax.jit(jax.vmap(_eigh_f64_seq))(b)
    assert bool(jnp.all(jnp.isfinite(w_seq)))
    assert bool(jnp.all(jnp.isfinite(u_seq)))
    for i in range(b.shape[0]):
        w_i, u_i = jnp.linalg.eigh(b[i])
        np.testing.assert_allclose(np.asarray(w_seq[i]), np.asarray(w_i),
                                   rtol=1e-12, atol=1e-14)
        # eigenvectors up to column sign
        s = np.sign(np.sum(np.asarray(u_seq[i]) * np.asarray(u_i),
                           axis=0))
        np.testing.assert_allclose(np.asarray(u_seq[i]) * s[None, :],
                                   np.asarray(u_i), rtol=1e-10,
                                   atol=1e-12)


def test_vmapped_eigen_reversible_finite_on_captured_params():
    """The engine path that hit the bug: vmapped per-class builds."""
    rng = np.random.default_rng(0)
    syms, freqs = [], []
    for i in range(4):
        # reconstruct sym/freqs pairs shaped like the failing fit's
        # (near-uniform GTR); exact B values above are the ground truth
        # exhibit, these drive the full eigen path
        r = 1.0 + rng.normal(0, 0.01, 6)
        f = np.full(4, 0.25) + rng.normal(0, 0.005, 4)
        f = np.abs(f) / np.abs(f).sum()
        s = np.zeros((4, 4))
        iu = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        for (a, bb), rr in zip(iu, r):
            s[a, bb] = s[bb, a] = rr
        syms.append(s)
        freqs.append(f)
    sym = jnp.asarray(np.stack(syms), jnp.float64)
    fr = jnp.asarray(np.stack(freqs), jnp.float64)
    eig = jax.jit(jax.vmap(eigen_reversible))(sym, fr)
    for leaf in (eig.evals, eig.evecs, eig.ivecs):
        assert bool(jnp.all(jnp.isfinite(leaf)))
