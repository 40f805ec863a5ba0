"""Deterministic fixed-trial RANSAC for small linear models, accelerator-style.

The reference fits ego-velocity models with
``sklearn.linear_model.RANSACRegressor(LinearRegression(fit_intercept=False),
residual_threshold=0.15, max_trials=20, min_samples=10, random_state=42)``
(``processors/velocity_estimator.py:379-386, 427-434``,
``point_cloud_processing/vel_estimator.py:95-101``).  A sequential
sample-fit-score loop with early stopping does not map to an accelerator; instead all
``max_trials`` hypotheses are evaluated in parallel as one batched closed-form
least-squares problem (the feature dimension is at most 3, so each fit is a
tiny normal-equations solve) and the winner is selected with sklearn's
criterion: most inliers, ties broken by the trial R^2 score.

Semantics matched to sklearn:
- inliers: ``|residual| <= residual_threshold``
- winner: lexicographic ``(n_inliers, score)``; the final model is refit on
  the winning trial's inlier set; ``R^2`` is evaluated on that same set.
Divergence: the PRNG stream (JAX threefry vs numpy legacy) and the absence of
adaptive early stopping — both affect only *which* random samples are drawn,
not the estimator's contract.  Runs are deterministic given ``key``.

Dynamic point counts are handled with a validity mask: invalid rows never
enter sampling, residual evaluation, or scoring.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    coef: jax.Array  # (D,) fitted coefficients (no intercept)
    r2: jax.Array  # () R^2 on the winning inlier set
    inlier_fraction: jax.Array  # () inliers / valid points
    inlier_mask: jax.Array  # (N,) winning inlier mask
    ok: jax.Array  # () bool: fit succeeded (enough valid points)


def _masked_lstsq(h: jax.Array, y: jax.Array, w: jax.Array) -> jax.Array:
    """Weighted closed-form LSQ ``argmin ||w*(y - H c)||`` for tiny D.

    Solves the normal equations with a relative ridge so rank-deficient
    selections (e.g. all-identical sample rows) stay finite.
    """
    hw = h * w[:, None]
    a = hw.T @ h  # (D, D)
    b = hw.T @ y  # (D,)
    d = a.shape[0]
    ridge = 1e-7 * (jnp.trace(a) / d + 1e-30)
    if d == 1:
        # scalar fast path: the velocity fits are 1-parameter models, and a
        # batched LU solve of 1x1 systems costs a dispatch-dominating custom
        # call where a divide is exact and fused
        return b / (a[0, 0] + ridge)
    return jnp.linalg.solve(a + ridge * jnp.eye(d, dtype=a.dtype), b)


def _masked_r2(y: jax.Array, pred: jax.Array, w: jax.Array) -> jax.Array:
    """R^2 over the rows selected by ``w`` (sklearn ``score`` semantics)."""
    n = jnp.sum(w)
    mean_y = jnp.sum(y * w) / jnp.maximum(n, 1.0)
    ss_res = jnp.sum(w * (y - pred) ** 2)
    ss_tot = jnp.sum(w * (y - mean_y) ** 2)
    return jnp.where(ss_tot > 0, 1.0 - ss_res / ss_tot, 0.0)


@partial(jax.jit, static_argnames=("min_samples", "max_trials"))
def ransac_linear(
    h: jax.Array,
    y: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    *,
    min_samples: int = 10,
    residual_threshold: float = 0.15,
    max_trials: int = 20,
) -> RansacResult:
    """Robust no-intercept linear fit ``y ~ H @ coef`` over masked points.

    Args:
        h: (N, D) design matrix (rows beyond ``valid`` are ignored).
        y: (N,) targets.
        valid: (N,) bool mask of live points.
        key: PRNG key (pass a fixed seed for reproducibility, mirroring
            the reference's ``random_state=42``).
    """
    n, d = h.shape
    h = h.astype(jnp.float32)
    y = y.astype(jnp.float32)
    validf = valid.astype(jnp.float32)
    n_valid = jnp.sum(validf)
    # structurally clamp the sample size; ``ok`` already gates the semantics
    # (fewer valid points than min_samples -> zero fallback, mirroring the
    # reference's sklearn ValueError path)
    k_sample = min(min_samples, n)

    def one_trial(trial_key):
        # Sample ``min_samples`` distinct valid rows via the Gumbel-top-k
        # trick, materialized as a THRESHOLD mask: ``score >= k-th largest``
        # selects exactly the top-k rows without the index scatter
        # (no per-trial ``.at[idx].set`` scatter).  Gumbel ties have measure
        # zero in f32; distinctness matches sklearn's sampling contract.
        g = jax.random.gumbel(trial_key, (n,))
        scores = jnp.where(valid, g, -jnp.inf)
        kth = jax.lax.top_k(scores, k_sample)[0][k_sample - 1]
        # with fewer than k_sample valid rows kth is -inf and every valid row
        # is selected (the ``ok`` flag already reports the fit as degenerate)
        w = ((scores >= kth) & valid).astype(jnp.float32)
        coef = _masked_lstsq(h, y, w)
        pred = h @ coef
        inliers = (jnp.abs(y - pred) <= residual_threshold) & valid
        n_in = jnp.sum(inliers)
        score = _masked_r2(y, pred, inliers.astype(jnp.float32))
        return coef, inliers, n_in, score

    keys = jax.random.split(key, max_trials)
    coefs, inlier_masks, n_ins, scores = jax.vmap(one_trial)(keys)

    # sklearn winner: max n_inliers, ties by score (later equal trials win).
    order = n_ins.astype(jnp.float32) * 1e6 + scores + jnp.arange(max_trials) * 1e-9
    best = jnp.argmax(order)
    # one-hot contraction instead of a row gather (no gather)
    best_inliers = jnp.sum(
        inlier_masks & (jnp.arange(max_trials) == best)[:, None], axis=0
    ) > 0
    best_w = best_inliers.astype(jnp.float32)

    # Refit on the winning inlier set (sklearn: final estimator.fit on inliers).
    final_coef = _masked_lstsq(h, y, best_w)
    n_in = jnp.sum(best_w)
    r2 = jnp.where(n_in > 3, _masked_r2(y, h @ final_coef, best_w), 0.0)
    inlier_fraction = jnp.where(n_valid > 0, n_in / jnp.maximum(n_valid, 1.0), 0.0)

    ok = n_valid >= min_samples
    zero = jnp.zeros_like(final_coef)
    return RansacResult(
        coef=jnp.where(ok, final_coef, zero),
        r2=jnp.where(ok, r2, 0.0),
        inlier_fraction=jnp.where(ok, inlier_fraction, 0.0),
        inlier_mask=best_inliers & ok,
        ok=ok,
    )
