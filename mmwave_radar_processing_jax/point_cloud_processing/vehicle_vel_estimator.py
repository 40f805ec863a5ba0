"""Hand-rolled RANSAC vehicle velocity estimator, vmapped.

Re-design of ``point_cloud_processing/vehicle_vel_estimator.py``: the
reference runs up to ``max_iters`` sequential trials of sample -> closed-form
LSQ -> grow inliers -> refit -> keep-best-MSE.  Here all trials evaluate in
parallel (one vmapped batch of tiny normal-equation solves) and the winner is
the minimum-MSE trial among those with more than ``num_close_pts`` inliers —
the same acceptance rule as the reference (:236-262).

Also implements the static-object prefilter: given an initial ego-velocity
estimate, drop detections whose measured velocity disagrees with the predicted
environment velocity by more than ``static_vel_thresh`` (:151-175).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("points_per_fit", "max_iters", "dims"))
def _ransac_trials(
    points: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    *,
    points_per_fit: int,
    max_iters: int,
    dims: int,
    fit_thresh: float,
    num_close_pts: int,
):
    """All-trials RANSAC: returns (best_fit, best_error, found)."""
    n = points.shape[0]
    p = points[:, :dims]
    h_all = p / jnp.maximum(jnp.linalg.norm(p, axis=1, keepdims=True), 1e-12)
    y_all = points[:, 3]
    validf = valid.astype(jnp.float32)

    def lsq(w):
        hw = h_all * w[:, None]
        a = hw.T @ h_all
        b = hw.T @ y_all
        ridge = 1e-7 * (jnp.trace(a) / dims + 1e-30)
        return jnp.linalg.solve(a + ridge * jnp.eye(dims), b)

    def one_trial(trial_key):
        g = jax.random.gumbel(trial_key, (n,))
        scores = jnp.where(valid, g, -jnp.inf)
        _, idx = jax.lax.top_k(scores, points_per_fit)
        w_seed = jnp.zeros((n,), jnp.float32).at[idx].set(1.0) * validf
        coef = lsq(w_seed)
        sq_err = (y_all - h_all @ coef) ** 2
        # grow: seed samples + remaining points under the fit threshold
        grown = (w_seed > 0) | ((sq_err < fit_thresh) & valid)
        n_in = jnp.sum(grown)
        ok = n_in > num_close_pts
        w_grown = grown.astype(jnp.float32)
        refit = lsq(w_grown)
        mse = jnp.sum(w_grown * (y_all - h_all @ refit) ** 2) / jnp.maximum(n_in, 1)
        return jnp.where(ok, mse, jnp.inf), refit

    keys = jax.random.split(key, max_iters)
    errors, fits = jax.vmap(one_trial)(keys)
    best = jnp.argmin(errors)
    return fits[best], errors[best], jnp.isfinite(errors[best])


class VehicleVelEstimator:
    """Ego-vehicle velocity via parallel-trial RANSAC over detections."""

    def __init__(
        self,
        points_per_fit: int = 7,
        max_iters: int = 100,
        fit_thresh: float = 0.05,
        num_close_pts: int = 10,
        static_vel_thresh: float = 0.2,
        seed: int = 0,
    ):
        self.points_per_fit = points_per_fit
        self.max_iters = max_iters
        self.fit_thresh = fit_thresh
        self.num_close_pts = num_close_pts
        self.static_vel_thresh = static_vel_thresh
        self.best_fit = None
        self.best_error = np.inf
        self._key = jax.random.PRNGKey(seed)

    # reference-compatible helpers -------------------------------------- #
    @staticmethod
    def lsq_fit_2D(detections: np.ndarray, only_2D: bool = True) -> np.ndarray:
        """Closed-form LSQ environment-velocity fit (reference :47-80)."""
        p = detections[:, 0:2] if only_2D else detections[:, 0:3]
        y = detections[:, 3]
        h = p / np.linalg.norm(p, axis=1, keepdims=True)
        return np.linalg.inv(h.T @ h) @ h.T @ y

    @staticmethod
    def lsq_predict(detections: np.ndarray, v: np.ndarray) -> np.ndarray:
        p = detections[:, 0 : v.shape[0]]
        h = p / np.linalg.norm(p, axis=1, keepdims=True)
        return h @ v

    @staticmethod
    def square_error_loss(v_true, v_pred):
        return (v_true - v_pred) ** 2

    def mean_square_error(self, v_true, v_pred):
        return float(np.sum(self.square_error_loss(v_true, v_pred)) / v_true.shape[0])

    def get_static_detections(self, detections: np.ndarray, ego_vel: np.ndarray):
        """Detections consistent with the predicted environment velocity."""
        env_vel = -np.asarray(ego_vel)
        v_pred = self.lsq_predict(detections, env_vel)
        errors = self.square_error_loss(detections[:, 3], v_pred)
        return detections[errors < self.static_vel_thresh, :]

    # ------------------------------------------------------------------ #
    def estimate_ego_vel(
        self,
        detections: np.ndarray,
        initial_ego_vel_est: np.ndarray = np.empty(0),
        only_2D: bool = True,
    ) -> np.ndarray:
        """Best ``[vx, vy]`` / ``[vx, vy, vz]`` ego velocity or empty array."""
        detections = np.asarray(detections, float)
        if detections.shape[0] < self.num_close_pts:
            return np.empty(0)
        if initial_ego_vel_est.shape[0] > 0:
            detections = self.get_static_detections(detections, initial_ego_vel_est)
            if detections.shape[0] < self.num_close_pts:
                return np.empty(0)

        self._key, sub = jax.random.split(self._key)
        dims = 2 if only_2D else 3
        fit, err, found = _ransac_trials(
            jnp.asarray(detections),
            jnp.ones(detections.shape[0], bool),
            sub,
            points_per_fit=self.points_per_fit,
            max_iters=self.max_iters,
            dims=dims,
            fit_thresh=self.fit_thresh,
            num_close_pts=self.num_close_pts,
        )
        if not bool(found):
            self.best_error = np.inf
            return np.empty(0)
        self.best_fit = np.asarray(fit)
        self.best_error = float(err)
        return -self.best_fit  # env velocity -> ego velocity

    def get_vehicle_vel_est(self):
        return -self.best_fit
