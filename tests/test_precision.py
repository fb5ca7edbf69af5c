"""Every contraction that feeds a parity-checked result pins its precision.

On a GPU an f32 matmul without a precision argument may run in TF32
(~3 decimal digits), and the atom sums below lose about that much, so each
``dot_general`` in these programs must carry an explicit precision.  The
check reads the traced program (jaxpr), so it runs on any platform.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psa_tpu.ops import instantaneous, spectral


def _dot_precisions(jaxpr):
    """The ``precision`` param of every dot_general, sub-programs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == 'dot_general':
            found.append(eqn.params['precision'])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(sub, 'eqns'):
                    found += _dot_precisions(sub)
                elif hasattr(sub, 'jaxpr') and hasattr(sub.jaxpr, 'eqns'):
                    found += _dot_precisions(sub.jaxpr)
    return found


T, K, A = 8, 5, 6
f32 = np.float32
CASES = {
    # L/T projection of the SED spectrum (k̂-weighted component sum)
    'spectral.lt_reduce': lambda: jax.make_jaxpr(spectral.lt_reduce)(
        np.ones((T, K, 3), f32), np.ones((T, K, 3), f32),
        np.ones((K, 3), f32), np.arange(4, dtype=np.int32)),
    # 3x3 cell inverse of the incremental phase engine's min-imaging
    'instantaneous._min_image_delta': lambda: jax.make_jaxpr(
        instantaneous._min_image_delta)(np.ones((T, A, 3), f32),
                                        np.eye(3, dtype=f32) * 10),
    # longitudinal current projection of the DSF planes
    'instantaneous.dsf_reduce': lambda: jax.make_jaxpr(
        lambda a, b, c, d: instantaneous.dsf_reduce(a, b, c, d, n_t=T))(
            np.ones((T, K, 4), f32), np.ones((T, K, 4), f32),
            np.ones((K, 3), f32), np.arange(4, dtype=np.int32)),
    # sum over every atom of the self ISF
    'instantaneous.isf_self_block': lambda: jax.make_jaxpr(
        lambda p, m, k: instantaneous.isf_self_block(p, m, k, n_lags=3))(
            np.ones((T, A, 3), f32), np.ones((A,), f32), np.ones((K, 3), f32)),
    # sum over every atom of the self DSF
    'instantaneous.dsf_self_block': lambda: jax.make_jaxpr(
        instantaneous.dsf_self_block)(
            np.ones((T, A, 3), f32), np.ones((A,), f32), np.ones((K, 3), f32),
            np.arange(4, dtype=np.int32)),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_contractions_pin_precision(name):
    precisions = _dot_precisions(CASES[name]().jaxpr)
    assert precisions, f"{name}: no dot_general traced"
    assert all(p is not None for p in precisions), (name, precisions)
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precisions), (name, precisions)


def test_parity_projection_is_compensated_above_one_block():
    """Above one atom block the parity projection sums per-block GEMMs with
    TwoSum, so its error does not grow with the atom count."""
    rng = np.random.default_rng(1)
    n = spectral._ATOM_BLOCK * 2 + 17
    data = rng.standard_normal((4, n, 3)).astype(f32)
    cs = rng.standard_normal((n, 6)).astype(f32)
    ref = np.einsum('tac,ak->tck', data.astype(np.float64), cs.astype(np.float64))
    out = jax.jit(lambda d, c: spectral._project(
        d, c, spectral.resolve_precision('parity')))(data, cs)
    assert out.shape == (4, 3, 6) and out.dtype == jnp.float32
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 1e-6
    prec = _dot_precisions(jax.make_jaxpr(lambda d, c: spectral._project(
        d, c, spectral.resolve_precision('parity')))(data, cs).jaxpr)
    assert len(prec) == 2        # the scanned block GEMM + the tail block
