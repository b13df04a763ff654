"""Constant-velocity Kalman filter on SORT's 7-dim box state.

State x = [cx, cy, s, r, dcx, dcy, ds] where s is box area and r the aspect
ratio (the parameterization used by the filterpy-based trackers the
reference reads at track.py:197-199: ``trk.kf.x.flatten()[4:6]`` are the
center velocities).

Copy of ``vbt_tpu.tracking.kalman``. Written against a pluggable array
namespace (``xp``): the host trackers call it with numpy on single states.

Benchmark copy: only the parts the plain reference runs are kept.
"""

from __future__ import annotations

import numpy as np

DIM_X = 7
DIM_Z = 4


_F = np.eye(DIM_X)
_F[0, 4] = _F[1, 5] = _F[2, 6] = 1.0
_H = np.zeros((DIM_Z, DIM_X))
_H[:, :DIM_Z] = np.eye(DIM_Z)
_R = np.diag([1.0, 1.0, 10.0, 10.0])
_Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])


def _constants(xp):
    return (xp.asarray(_F), xp.asarray(_H), xp.asarray(_R), xp.asarray(_Q))


def initial_covariance(xp=np):
    """P0 = diag(10,10,10,10,1e4,1e4,1e4) — high velocity uncertainty."""
    return xp.diag(xp.asarray([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4]))


def bbox_to_z(bbox, xp=np):
    """[x1,y1,x2,y2] -> measurement [cx, cy, area, aspect]. Broadcasts."""
    bbox = xp.asarray(bbox)
    w = bbox[..., 2] - bbox[..., 0]
    h = bbox[..., 3] - bbox[..., 1]
    return xp.stack(
        [bbox[..., 0] + w / 2.0, bbox[..., 1] + h / 2.0, w * h, w / h], axis=-1
    )


def z_to_bbox(z, xp=np):
    """[cx, cy, s, r] -> [x1,y1,x2,y2]. Broadcasts; clamps s*r at 0."""
    z = xp.asarray(z)
    w = xp.sqrt(xp.maximum(z[..., 2] * z[..., 3], 0.0))
    h = xp.where(w > 0, z[..., 2] / xp.where(w > 0, w, 1.0), 0.0)
    return xp.stack(
        [
            z[..., 0] - w / 2.0,
            z[..., 1] - h / 2.0,
            z[..., 0] + w / 2.0,
            z[..., 1] + h / 2.0,
        ],
        axis=-1,
    )


def kf_init(z, xp=np):
    """New filter from a measurement: zero velocities, P0 covariance."""
    z = xp.asarray(z)
    x = xp.concatenate([z, xp.zeros(z.shape[:-1] + (3,))], axis=-1)
    p = xp.broadcast_to(initial_covariance(xp), z.shape[:-1] + (DIM_X, DIM_X))
    return x, p


def kf_predict(x, p, xp=np):
    """Predict step. Broadcasts over leading axes of x (..., 7) / p (..., 7, 7).

    SORT quirk: if predicted area would go non-positive, zero the area
    velocity first.
    """
    f, _, _, q = _constants(xp)
    ds = xp.where(x[..., 6] + x[..., 2] <= 0, 0.0, x[..., 6])
    if hasattr(x, "at"):
        x = x.at[..., 6].set(ds)
    else:
        x = x.copy()
        x[..., 6] = ds
    x_new = xp.einsum("ij,...j->...i", f, x)
    p_new = xp.einsum("ij,...jk,lk->...il", f, p, f) + q
    return x_new, p_new


def kf_update(x, p, z, xp=np):
    """Measurement update with z (..., 4). Joseph-free standard KF update."""
    _, h, r, _ = _constants(xp)
    y = z - xp.einsum("ij,...j->...i", h, x)  # innovation
    s = xp.einsum("ij,...jk,lk->...il", h, p, h) + r  # (...,4,4)
    s_inv = xp.linalg.inv(s)
    k = xp.einsum("...ij,kj,...kl->...il", p, h, s_inv)  # (...,7,4)
    x_new = x + xp.einsum("...ij,...j->...i", k, y)
    kh = xp.einsum("...ij,jk->...ik", k, h)
    identity = xp.eye(DIM_X)
    p_new = xp.einsum("...ij,...jk->...ik", identity - kh, p)
    return x_new, p_new


def state_bbox(x, xp=np):
    """Current state as [x1,y1,x2,y2]."""
    return z_to_bbox(x[..., :DIM_Z], xp)
