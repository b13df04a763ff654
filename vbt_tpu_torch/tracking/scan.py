"""Fixed-capacity multi-object tracker over whole videos, batched over clips.

Port of ``vbt_tpu.tracking.scan``. The JAX package compiled the frame loop
into one ``lax.scan``; here :func:`tracker_step` is the same step written
with torch ops over a leading clips axis, and the frame loop is the CUDA
kernel K3 (``csrc/track_scan.cu``, one warp a clip) on the card.
:func:`track_video` (and ``runtime.batch_runner.track_clips``) dispatch on
the tensors' device: a CUDA tensor goes to the kernel, which takes float32
only, or raises; a CPU tensor (or a numpy array) goes to the plain version,
:func:`scan_clips_plain`, a Python loop over frames of :func:`tracker_step`.

One configurable tracker covers both reference generations:

- ``ScanTrackerConfig.sort()`` — SORT semantics (IoU affinity, no momentum,
  no recovery);
- ``ScanTrackerConfig.ocsort()`` — OC-SORT semantics (DIoU affinity, OCM
  momentum, OCR last-observation recovery, ORU virtual-trajectory
  re-update).

``max_tracks`` slots with an ``alive`` mask replace the host tracker's
lists; ids come from a carried counter in detection order, so runs agree
id for id with the host trackers. Two divergences from the original are
mirrored, not fixed: births beyond the free slots are dropped while the id
counter still advances (the 16-slot cap), and in float32 the huge initial
covariances leave an early-track transient in ``dxdy``.

``mode="drop"`` scatters of the JAX step write to an extra dump slot that is
sliced off; ``.at[].max`` is ``scatter_reduce("amax")``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vbt_tpu_torch.tracking.assignment import hungarian
from vbt_tpu_torch.tracking.association import (
    ASSO_FUNCS_TORCH,
    direction_consistency_torch,
    speed_direction_torch,
)
from vbt_tpu_torch.tracking.kalman import (
    DIM_X,
    bbox_to_z_torch,
    initial_covariance_torch,
    kf_predict_torch,
    kf_update_torch,
    state_bbox_torch,
)

INVALID_COST = 1e4


class ScanTrackerConfig(NamedTuple):
    max_tracks: int = 16
    max_age: int = 30
    min_hits: int = 3
    iou_threshold: float = 0.3
    asso: str = "iou"
    inertia: float = 0.2
    delta_t: int = 3
    use_momentum: bool = False  # OCM
    use_recovery: bool = False  # OCR
    use_reupdate: bool = False  # ORU
    report_observation: bool = False  # OC-SORT reports last obs, SORT the KF state

    @classmethod
    def sort(cls, max_age=1, min_hits=1, iou_threshold=0.3, max_tracks=16):
        return cls(max_tracks=max_tracks, max_age=max_age, min_hits=min_hits,
                   iou_threshold=iou_threshold, asso="iou")

    @classmethod
    def ocsort(cls, max_age=30, min_hits=1, iou_threshold=0.3, asso="iou", inertia=0.2,
               delta_t=3, max_tracks=16):
        return cls(max_tracks=max_tracks, max_age=max_age, min_hits=min_hits,
                   iou_threshold=iou_threshold, asso=asso, inertia=inertia, delta_t=delta_t,
                   use_momentum=True, use_recovery=True, use_reupdate=True,
                   report_observation=True)


class TrackerState(NamedTuple):
    """Every field has a leading clips axis C."""

    x: torch.Tensor  # (C, S, 7) Kalman mean
    p: torch.Tensor  # (C, S, 7, 7) Kalman covariance
    alive: torch.Tensor  # (C, S) bool
    tsu: torch.Tensor  # (C, S) int32 time_since_update
    hits: torch.Tensor
    hit_streak: torch.Tensor
    age: torch.Tensor
    track_id: torch.Tensor  # (C, S) int32, 1-based
    conf: torch.Tensor  # (C, S)
    cls: torch.Tensor
    last_obs: torch.Tensor  # (C, S, 5) [x1,y1,x2,y2,score]; score<0 == none yet
    velocity: torch.Tensor  # (C, S, 2) OCM unit direction (dy, dx)
    obs_ring: torch.Tensor  # (C, S, delta_t, 5) observation ring by age
    ring_age: torch.Tensor  # (C, S, delta_t) int32 age stamps (-1 == empty)
    frozen_x: torch.Tensor  # (C, S, 7) ORU rollback state
    frozen_p: torch.Tensor  # (C, S, 7, 7)
    has_frozen: torch.Tensor  # (C, S) bool
    miss_gap: torch.Tensor  # (C, S) int32 coasted frames since freeze
    next_id: torch.Tensor  # (C,) int32
    frame: torch.Tensor  # (C,) int32


class FrameTracks(NamedTuple):
    """Scan output, one row per slot; ``report`` masks real rows. The other
    fields are defined where ``report`` is set."""

    report: torch.Tensor  # (..., S) bool
    box: torch.Tensor  # (..., S, 4) [x1,y1,x2,y2]
    track_id: torch.Tensor  # (..., S) int32
    conf: torch.Tensor  # (..., S)
    cls: torch.Tensor  # (..., S)
    dxdy: torch.Tensor  # (..., S, 2) Kalman center velocities


def init_state(cfg: ScanTrackerConfig, clips: int, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cpu") -> TrackerState:
    c, s, dt = clips, cfg.max_tracks, cfg.delta_t

    def full(shape, value, dtype_=dtype):
        return torch.full(shape, value, dtype=dtype_, device=device)

    return TrackerState(
        x=full((c, s, DIM_X), 0.0),
        p=initial_covariance_torch(dtype, device).expand(c, s, DIM_X, DIM_X).clone(),
        alive=full((c, s), False, torch.bool),
        tsu=full((c, s), 0, torch.int32),
        hits=full((c, s), 0, torch.int32),
        hit_streak=full((c, s), 0, torch.int32),
        age=full((c, s), 0, torch.int32),
        track_id=full((c, s), 0, torch.int32),
        conf=full((c, s), 0.0),
        cls=full((c, s), 0.0),
        last_obs=full((c, s, 5), -1.0),
        velocity=full((c, s, 2), 0.0),
        obs_ring=full((c, s, dt, 5), -1.0),
        ring_age=full((c, s, dt), -1, torch.int32),
        frozen_x=full((c, s, DIM_X), 0.0),
        frozen_p=full((c, s, DIM_X, DIM_X), 0.0),
        has_frozen=full((c, s), False, torch.bool),
        miss_gap=full((c, s), 0, torch.int32),
        next_id=full((c,), 1, torch.int32),
        frame=full((c,), 0, torch.int32),
    )


def _sel(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Broadcast a mask over the trailing dims of ``new`` and select."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)


def _gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[c, idx[c, k], ...]`` for a (C, N, ...) tensor and (C, K) indices."""
    idx = idx.long().reshape(idx.shape + (1,) * (a.dim() - 2))
    return torch.take_along_dim(a, idx, dim=1)


def _k_previous_obs(st: TrackerState, cfg: ScanTrackerConfig) -> torch.Tensor:
    """Per-slot reference observation delta_t..1 frames back (the largest
    found), falling back to the last observation."""
    out = st.last_obs
    for dt in range(1, cfg.delta_t + 1):
        want_age = st.age - dt
        slot = torch.remainder(want_age, cfg.delta_t).long()
        stamped = torch.take_along_dim(st.ring_age, slot[..., None], dim=2)[..., 0]
        obs = torch.take_along_dim(st.obs_ring, slot[..., None, None], dim=2)[..., 0, :]
        valid = (stamped == want_age) & (want_age >= 0)
        out = _sel(valid, obs, out)
    return out


def _assign(square: torch.Tensor, needed: torch.Tensor) -> torch.Tensor:
    """:func:`hungarian` for each clip whose result is used; -1 rows for the
    others (their result is masked out by the caller)."""
    out = torch.full(square.shape[:2], -1, dtype=torch.int32, device=square.device)
    for c in torch.nonzero(needed).flatten().tolist():
        out[c] = hungarian(square[c])
    return out


def tracker_step(cfg: ScanTrackerConfig, st: TrackerState, dets: torch.Tensor,
                 det_valid: torch.Tensor) -> tuple[TrackerState, FrameTracks]:
    """One frame of every clip: predict, associate, (recover), update,
    birth, report. ``dets`` (C, D, 6) rows [x1,y1,x2,y2,score,cls] in the
    state's dtype; ``det_valid`` (C, D) bool."""
    dtype, dev = st.x.dtype, st.x.device
    dets = dets.to(dtype)
    n_clips, S = st.alive.shape
    D = dets.shape[1]
    affinity_fn = ASSO_FUNCS_TORCH[cfg.asso]
    i32 = torch.int32

    # ---- predict ---------------------------------------------------------------
    x_pred, p_pred = kf_predict_torch(st.x, st.p)
    alive = st.alive
    st = st._replace(
        x=_sel(alive, x_pred, st.x),
        p=_sel(alive, p_pred, st.p),
        age=torch.where(alive, st.age + 1, st.age),
        hit_streak=torch.where(alive & (st.tsu > 0), 0, st.hit_streak),
        tsu=torch.where(alive, st.tsu + 1, st.tsu),
        frame=st.frame + 1,
    )
    trk_boxes = state_bbox_torch(st.x)

    # ---- association cost --------------------------------------------------------
    pair_valid = det_valid[:, :, None] & alive[:, None, :]
    affinity = affinity_fn(dets[..., :4], trk_boxes)
    affinity = torch.where(pair_valid, affinity, -1.0)
    cost = -affinity
    k_obs = None
    if cfg.use_momentum:
        k_obs = _k_previous_obs(st, cfg)
        momentum = direction_consistency_torch(dets[..., :4], k_obs, st.velocity)
        cost = cost - cfg.inertia * torch.where(pair_valid, momentum, 0.0)
    cost = torch.where(pair_valid, cost, INVALID_COST)

    n = max(D, S)
    square = torch.full((n_clips, n, n), INVALID_COST, dtype=torch.float32, device=dev)
    square[:, :D, :S] = cost.to(torch.float32)

    # SORT shortcut: a thresholded affinity that is already a partial
    # permutation is taken as it is (argmax over bools: the first True).
    over = (affinity > cfg.iou_threshold) & pair_valid
    is_perm = (over.sum(2) <= 1).all(1) & (over.sum(1) <= 1).all(1)
    shortcut_slot = torch.where(over.any(2), torch.argmax(over.to(i32), dim=2), -1)
    col_of_row = _assign(square, ~is_perm)  # det row -> slot col
    hung_slot = torch.where(col_of_row[:, :D] < S, col_of_row[:, :D], -1)
    cand_slot = torch.where(is_perm[:, None], shortcut_slot, hung_slot)

    gathered_aff = torch.take_along_dim(affinity, cand_slot.clamp(min=0)[..., None].long(),
                                        dim=2)[..., 0]
    det_matched = (cand_slot >= 0) & (gathered_aff >= cfg.iou_threshold) & det_valid
    match_slot = torch.where(det_matched, cand_slot, -1)

    # ---- OCR: second association round by last observation -----------------------
    if cfg.use_recovery:
        slot_matched_now = torch.zeros((n_clips, S), dtype=i32, device=dev).scatter_reduce(
            1, match_slot.clamp(min=0).long(), det_matched.to(i32), "amax").bool()
        left_det = det_valid & ~det_matched
        left_trk = alive & ~slot_matched_now & (st.last_obs[..., 4] >= 0)
        pair2 = left_det[:, :, None] & left_trk[:, None, :]
        aff2 = affinity_fn(dets[..., :4], st.last_obs[..., :4])
        aff2 = torch.where(pair2, aff2, -1.0)
        do_ocr = aff2.amax(dim=(1, 2)) > cfg.iou_threshold
        square2 = torch.full((n_clips, n, n), INVALID_COST, dtype=torch.float32, device=dev)
        square2[:, :D, :S] = torch.where(pair2, -aff2, INVALID_COST).to(torch.float32)
        col2 = _assign(square2, do_ocr)
        slot2 = torch.where(col2[:, :D] < S, col2[:, :D], -1)
        aff2_g = torch.take_along_dim(aff2, slot2.clamp(min=0)[..., None].long(), dim=2)[..., 0]
        det_matched2 = (do_ocr[:, None] & (slot2 >= 0) & (aff2_g >= cfg.iou_threshold)
                        & left_det)
        match_slot = torch.where(det_matched2, slot2, match_slot)
        det_matched = det_matched | det_matched2

    # ---- per-slot match: slot_det[s] = the detection matched to slot s or -1 -----
    # Unmatched rows write to the dump slot S, which is sliced off.
    slot_det = torch.full((n_clips, S + 1), -1, dtype=i32, device=dev)
    slot_det.scatter_(1, torch.where(det_matched, match_slot, S).long(),
                      torch.arange(D, dtype=i32, device=dev).expand(n_clips, D).contiguous())
    slot_det = slot_det[:, :S]
    slot_matched = slot_det >= 0
    det_for_slot = _gather(dets, slot_det.clamp(min=0))  # (C, S, 6)

    # ---- ORU: rollback + virtual trajectory replay --------------------------------
    # From the frozen state of the first missed frame, update-then-predict
    # cycles with virtual observations interpolated in measurement space; the
    # last virtual equals the real observation and consumes it.
    oru = torch.zeros_like(slot_matched)
    if cfg.use_reupdate:
        oru = slot_matched & st.has_frozen & (st.tsu > 1) & (st.last_obs[..., 4] >= 0)
        if bool(oru.any()):
            x_r = _sel(oru, st.frozen_x, st.x)
            p_r = _sel(oru, st.frozen_p, st.p)
            z1 = bbox_to_z_torch(st.last_obs[..., :4])
            z2 = bbox_to_z_torch(det_for_slot[..., :4])
            w1 = torch.sqrt(z1[..., 2] * z1[..., 3])
            h1 = torch.sqrt(z1[..., 2] / z1[..., 3])
            w2 = torch.sqrt(z2[..., 2] * z2[..., 3])
            h2 = torch.sqrt(z2[..., 2] / z2[..., 3])
            gap = (st.miss_gap + 1).to(dtype)
            # Steps past every replayed slot's gap change nothing.
            last_k = min(cfg.max_age + 1, int(torch.where(oru, st.miss_gap + 1, 0).max()))
            for k in range(1, last_k + 1):
                active = oru & (k <= st.miss_gap + 1)
                frac = torch.tensor(k, dtype=dtype, device=dev) / gap
                w = w1 + frac * (w2 - w1)
                h = h1 + frac * (h2 - h1)
                virtual_z = torch.stack([z1[..., 0] + frac * (z2[..., 0] - z1[..., 0]),
                                         z1[..., 1] + frac * (z2[..., 1] - z1[..., 1]),
                                         w * h, w / h], dim=-1)
                xu, pu = kf_update_torch(x_r, p_r, virtual_z)
                xp, pp = kf_predict_torch(xu, pu)
                not_last = k < st.miss_gap + 1
                x_r = _sel(active, _sel(not_last, xp, xu), x_r)
                p_r = _sel(active, _sel(not_last, pp, pu), p_r)
            st = st._replace(x=_sel(oru, x_r, st.x), p=_sel(oru, p_r, st.p))

    # ---- OCM velocity + observation bookkeeping ------------------------------------
    if cfg.use_momentum:
        had_obs = st.last_obs[..., 4] >= 0
        vel_new = speed_direction_torch(k_obs[..., :4], det_for_slot[..., :4])
        st = st._replace(velocity=_sel(slot_matched & had_obs, vel_new, st.velocity))

    new_obs = det_for_slot[..., :5]
    ring_slot = torch.remainder(st.age, cfg.delta_t)
    in_ring = slot_matched[..., None] & (
        torch.arange(cfg.delta_t, device=dev)[None, None, :] == ring_slot[..., None])
    obs_ring = torch.where(in_ring[..., None], new_obs[:, :, None, :], st.obs_ring)
    ring_age = torch.where(in_ring, st.age[..., None], st.ring_age)

    # ---- measurement update (ORU-replayed slots already consumed it) ---------------
    x_u, p_u = kf_update_torch(st.x, st.p, bbox_to_z_torch(det_for_slot[..., :4]))
    upd = slot_matched & ~oru
    st = st._replace(
        x=_sel(upd, x_u, st.x),
        p=_sel(upd, p_u, st.p),
        tsu=torch.where(slot_matched, 0, st.tsu),
        hits=torch.where(slot_matched, st.hits + 1, st.hits),
        hit_streak=torch.where(slot_matched, st.hit_streak + 1, st.hit_streak),
        conf=torch.where(slot_matched, det_for_slot[..., 4], st.conf),
        cls=torch.where(slot_matched, det_for_slot[..., 5], st.cls),
        last_obs=_sel(slot_matched, new_obs, st.last_obs),
        obs_ring=obs_ring,
        ring_age=ring_age,
        has_frozen=torch.where(slot_matched, False, st.has_frozen),
        miss_gap=torch.where(slot_matched, 0, st.miss_gap),
    )

    # ---- misses: freeze for ORU ----------------------------------------------------
    missed = st.alive & ~slot_matched
    if cfg.use_reupdate:
        freeze_now = missed & ~st.has_frozen
        st = st._replace(
            frozen_x=_sel(freeze_now, st.x, st.frozen_x),
            frozen_p=_sel(freeze_now, st.p, st.frozen_p),
            has_frozen=st.has_frozen | freeze_now,
            miss_gap=torch.where(missed, st.miss_gap + 1, st.miss_gap),
        )

    # ---- births: the r-th new detection takes the r-th free slot --------------------
    new_det = det_valid & ~det_matched
    det_rank = torch.cumsum(new_det.to(i32), dim=1) - 1  # (C, D)
    free = ~st.alive
    free_rank = torch.cumsum(free.to(i32), dim=1) - 1  # (C, S)
    num_free = free.sum(1)
    slot_of_rank = torch.zeros((n_clips, S + 1), dtype=i32, device=dev)
    slot_of_rank.scatter_(1, torch.where(free, free_rank, S).long(),
                          torch.arange(S, dtype=i32, device=dev).expand(n_clips, S).contiguous())
    birth_ok = new_det & (det_rank < num_free[:, None])
    birth_slot = torch.take_along_dim(slot_of_rank, det_rank.clamp(0, S - 1).long(), dim=1)
    slot_birth_det = torch.full((n_clips, S + 1), -1, dtype=i32, device=dev)
    slot_birth_det.scatter_(1, torch.where(birth_ok, birth_slot, S).long(),
                            torch.arange(D, dtype=i32, device=dev).expand(n_clips, D).contiguous())
    slot_birth_det = slot_birth_det[:, :S]
    is_birth = slot_birth_det >= 0
    bdet = _gather(dets, slot_birth_det.clamp(min=0))
    bx = torch.cat([bbox_to_z_torch(bdet[..., :4]),
                    torch.zeros((n_clips, S, 3), dtype=dtype, device=dev)], dim=-1)
    birth_rank = torch.take_along_dim(det_rank, slot_birth_det.clamp(min=0).long(), dim=1)
    bids = st.next_id[:, None] + torch.where(is_birth, birth_rank, 0)

    st = st._replace(
        x=_sel(is_birth, bx, st.x),
        p=_sel(is_birth, initial_covariance_torch(dtype, dev).expand(n_clips, S, DIM_X, DIM_X),
               st.p),
        alive=st.alive | is_birth,
        tsu=torch.where(is_birth, 0, st.tsu),
        hits=torch.where(is_birth, 0, st.hits),
        hit_streak=torch.where(is_birth, 0, st.hit_streak),
        age=torch.where(is_birth, 0, st.age),
        track_id=torch.where(is_birth, bids, st.track_id).to(i32),
        conf=torch.where(is_birth, bdet[..., 4], st.conf),
        cls=torch.where(is_birth, bdet[..., 5], st.cls),
        last_obs=_sel(is_birth, torch.full_like(st.last_obs, -1.0), st.last_obs),
        velocity=_sel(is_birth, torch.zeros_like(st.velocity), st.velocity),
        obs_ring=_sel(is_birth, torch.full_like(st.obs_ring, -1.0), st.obs_ring),
        ring_age=_sel(is_birth, torch.full_like(st.ring_age, -1), st.ring_age),
        has_frozen=torch.where(is_birth, False, st.has_frozen),
        miss_gap=torch.where(is_birth, 0, st.miss_gap),
        next_id=(st.next_id + new_det.sum(1)).to(i32),
    )

    # ---- report -------------------------------------------------------------------
    report = st.alive & (st.tsu < 1) & (
        (st.hit_streak >= cfg.min_hits) | (st.frame[:, None] <= cfg.min_hits))
    box = state_bbox_torch(st.x)
    if cfg.report_observation:
        box = _sel(st.last_obs[..., 4] >= 0, st.last_obs[..., :4], box)
    out = FrameTracks(report=report, box=box, track_id=st.track_id, conf=st.conf,
                      cls=st.cls, dxdy=st.x[..., 4:6])

    # ---- deaths -------------------------------------------------------------------
    st = st._replace(alive=st.alive & (st.tsu <= cfg.max_age))
    return st, out


def make_scan_step(cfg: ScanTrackerConfig, skip_empty_frames: bool):
    """The per-frame step with the reference's empty-frame skip (a frame
    without detections leaves the state untouched and reports nothing);
    ``frame_valid`` (C,) marks padding frames, which are inert too."""

    def step(st: TrackerState, dets, det_valid, frame_valid):
        new_st, out = tracker_step(cfg, st, dets, det_valid)
        active = frame_valid & det_valid.any(1) if skip_empty_frames else frame_valid
        new_st = TrackerState(*(_sel(active, a, b) for a, b in zip(new_st, st)))
        return new_st, out._replace(report=out.report & active[:, None])

    return step


def scan_clips_plain(cfg: ScanTrackerConfig, dets: torch.Tensor, det_valid: torch.Tensor,
                     frame_valid: torch.Tensor, skip_empty_frames: bool = True,
                     state: TrackerState | None = None, return_state: bool = False):
    """The plain version of kernel K3: ``dets`` (C, T, D, 6), ``det_valid``
    (C, T, D), ``frame_valid`` (C, T) -> FrameTracks (C, T, S, ...), in the
    dtype of ``dets`` and on its device, one :func:`tracker_step` a frame.
    ``state`` is the clips' initial state (``None``: :func:`init_state`);
    with ``return_state`` the result is ``(final state, FrameTracks)``."""
    n_clips, t_frames = dets.shape[:2]
    st = init_state(cfg, n_clips, dets.dtype, dets.device) if state is None else state
    step = make_scan_step(cfg, skip_empty_frames)
    outs = []
    for t in range(t_frames):
        st, out = step(st, dets[:, t], det_valid[:, t], frame_valid[:, t])
        outs.append(out)
    if not outs:  # no frames: every field (C, 0, S, ...)
        _, out = step(st, dets.new_zeros((n_clips,) + dets.shape[2:]),
                      det_valid.new_zeros((n_clips,) + det_valid.shape[2:]),
                      frame_valid.new_zeros((n_clips,)))
        tracks = FrameTracks(*(f[:, None][:, :0] for f in out))
    else:
        tracks = FrameTracks(*(torch.stack(field, dim=1) for field in zip(*outs)))
    return (st, tracks) if return_state else tracks


def _as_tensors(*arrays) -> tuple[torch.Tensor, ...]:
    """numpy arrays -> CPU tensors; tensors as they are."""
    return tuple(a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
                 for a in arrays)


def scan_clips(cfg: ScanTrackerConfig, dets, det_valid, frame_valid,
               skip_empty_frames: bool = True, state: TrackerState | None = None,
               return_state: bool = False):
    """Dispatch on the device: CUDA tensors to kernel K3 (float32 only; it
    raises on what it does not take), CPU tensors and numpy arrays to
    :func:`scan_clips_plain`. ``state`` and ``return_state`` as there."""
    dets, det_valid, frame_valid = _as_tensors(dets, det_valid, frame_valid)
    if dets.device.type == "cuda":
        from vbt_tpu_torch.ops.track_scan_cuda import track_scan

        out = track_scan(cfg, dets, det_valid, frame_valid, skip_empty_frames, state=state,
                         return_state=return_state)
        return (out[0], FrameTracks(*out[1])) if return_state else FrameTracks(*out)
    if dets.device.type != "cpu":
        raise ValueError(f"unsupported device {dets.device}")
    return scan_clips_plain(cfg, dets, det_valid.bool(), frame_valid.bool(), skip_empty_frames,
                            state=state, return_state=return_state)


def track_video(cfg: ScanTrackerConfig, dets, det_valid,
                skip_empty_frames: bool = True) -> FrameTracks:
    """Track one video: ``dets`` (T, D, 6), ``det_valid`` (T, D) ->
    FrameTracks stacked over T. With ``skip_empty_frames`` (the reference
    behaviour) a frame without a valid detection leaves the tracker state
    untouched and reports nothing."""
    dets, det_valid = _as_tensors(dets, det_valid)
    frame_valid = torch.ones(dets.shape[:1], dtype=torch.bool, device=dets.device)
    out = scan_clips(cfg, dets[None], det_valid[None], frame_valid[None], skip_empty_frames)
    return FrameTracks(*(f[0] for f in out))
