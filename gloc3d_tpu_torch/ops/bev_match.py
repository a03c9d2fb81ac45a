"""BEV registration by exhaustive rotation × translation FFT search.

Port of ``gloc3d_tpu/ops/bev_match.py`` (``match_bev_topk``, ``match_bev``)
with ``torch.fft`` (cuFFT on the card): a coarse stage correlates a
max-pooled rotation stack (three-shear FFT rotations) against every
candidate, and a fine stage correlates a small rotation fan around each
candidate's coarse angle at full resolution. Output contract: metric
(dx, dy, yaw) taking query points to db points, a normalised correlation
score, and the score / overlap accept gate.

The candidate axis is a batch dimension here. The JAX package's
``optimization_barrier`` calls and its ``lax.map`` FFT batch chunking are
XLA workarounds and are not ported. This PR ports the default
``MatchConfig`` path (``coarse_mode="stack"``, single-stage fine,
``fine_top_f=0``, ``overlap_norm=False``); the ``fast_match`` preset's
options raise ``NotImplementedError`` (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gloc3d_tpu_torch.ops.bev import BEVImage


class MatchResult(NamedTuple):
    """Rigid 2-D registration of a query BEV image onto db BEV images."""

    xy_yaw: torch.Tensor   # (..., 3) [dx, dy, yaw]: p_db = R(yaw)·p_q + t
    score: torch.Tensor    # (...) normalised correlation peak
    overlap: torch.Tensor  # (...) occupied-pixel overlap at the peak
    success: torch.Tensor  # (...) bool: clears the score and overlap gates
    scale: torch.Tensor    # (...) always 1.0 (rigid)
    ratio: torch.Tensor    # (...) peak sharpness; 0 when not computed


def _good_fft_size(n: int) -> int:
    """Smallest m >= n whose factorization uses only 2/3/5/7."""
    m = n
    while True:
        r = m
        for p in (2, 3, 5, 7):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 1


def _check_supported(cfg) -> None:
    unsupported = {
        "coarse_mode": cfg.coarse_mode != "stack",
        "fine_argmax_downsample": int(cfg.fine_argmax_downsample) > 1,
        "fine_top_f": cfg.fine_top_f != 0,
        "overlap_norm": bool(cfg.overlap_norm),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"MatchConfig {bad}: the fast_match / Fourier-Mellin / masked-NCC "
            "matcher options come with ROADMAP Queue 1, item 8")


def _occupancy(img: torch.Tensor) -> torch.Tensor:
    """BEV image (free=1, occupied=0) → binary occupancy (occupied=1)."""
    return (img < 0.5).float()


def _maxpool(img: torch.Tensor, f: int) -> torch.Tensor:
    s = img.shape[-1] // f
    x = img[..., : s * f, : s * f].reshape(img.shape[:-2] + (s, f, s, f))
    return x.amax(dim=(-3, -1))


def _phase(n: int, k: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """exp(−2πi/n · k · shift) in complex64, k and shift broadcast."""
    ang = (torch.tensor(-2.0 * math.pi / n, device=k.device) * k) * shift
    return torch.polar(torch.ones_like(ang), ang)


def _shear_x_fft(img: torch.Tensor, s: torch.Tensor, center=None
                 ) -> torch.Tensor:
    """Shift row y of each (..., H, W) image by s·(y − c) along x via FFT
    phase (subpixel, circular); ``s`` has the images' leading shape."""
    n = img.shape[-1]
    dev = img.device
    f = torch.fft.rfft(img, dim=-1)
    k = torch.arange(n // 2 + 1, device=dev, dtype=torch.float32)
    cy = (img.shape[-2] - 1) / 2.0 if center is None else center
    y = torch.arange(img.shape[-2], device=dev, dtype=torch.float32) - cy
    sy = s[..., None] * y                                   # (..., H)
    return torch.fft.irfft(f * _phase(n, k, sy[..., :, None]), n=n, dim=-1)


def _rotate_image_shear(img: torch.Tensor, angles: torch.Tensor
                        ) -> torch.Tensor:
    """Rotate (B, S, S) images about their centres, image b by angles[b]
    (or one image, B = 1, by every angle) → (R, S, S).

    Exact 90° steps by ``rot90`` plus the residual (|θ| ≤ 45°) as three FFT
    shears on a √2-sized canvas, then cropped and clipped to [0, 1]."""
    s = img.shape[-1]
    pad = _good_fft_size(int(math.ceil(s * math.sqrt(2.0))) + 2)
    while (pad - s) % 2:  # exact centre alignment needs even (pad − s)
        pad = _good_fft_size(pad + 1)
    off = (pad - s) // 2
    r = angles.shape[0]
    canvas = img.new_zeros(img.shape[:-2] + (pad, pad))
    canvas[..., off : off + s, off : off + s] = img

    quarter = math.pi / 2.0
    turns = torch.round(angles / quarter)
    k90 = turns.long() % 4
    residual = angles - turns * quarter
    # rot90 turns axis 0 toward axis 1: a MATH-NEGATIVE rotation in the
    # (row = y, col = x) image convention, so +90° steps use k = −1
    rots = torch.stack([canvas,
                        torch.rot90(canvas, -1, dims=(-2, -1)),
                        torch.rot90(canvas, 2, dims=(-2, -1)),
                        torch.rot90(canvas, 1, dims=(-2, -1))])
    which = (torch.arange(r, device=img.device) if canvas.shape[0] == r
             else torch.zeros(r, dtype=torch.long, device=img.device))
    base = rots[k90, which]                                 # (R, pad, pad)
    a = -torch.tan(residual / 2.0)
    b = torch.sin(residual)
    out = _shear_x_fft(_shear_x_fft(base, a).transpose(-1, -2), b
                       ).transpose(-1, -2)
    out = _shear_x_fft(out, a)
    return out[..., off : off + s, off : off + s].clamp(0.0, 1.0)


def _fan_rfft2(img: torch.Tensor, angles: torch.Tensor, pad: int,
               max_abs: float) -> torch.Tensor:
    """``conj(rfft2(``small-angle rotation fan of (S, S) ``img`` on a
    (pad, pad) top-left canvas``))`` → (R, pad, pad//2+1) complex64, with
    the shear FFTs fused into the correlation FFT (see the JAX docstring
    for the guard band that keeps the circular wrap out)."""
    s = img.shape[-1]
    n = pad
    dev = img.device
    canvas = img.new_zeros((pad, pad))
    canvas[:s, :s] = img
    c = (s - 1) / 2.0
    guard = s + (pad - s) // 2
    drift3 = int(math.ceil(math.tan(max_abs / 2.0) * (s / 2.0))) + 1
    ar = torch.arange(pad, device=dev)
    keep = ((ar < guard)[:, None] & (ar < guard - drift3)[None, :]).float()
    k = torch.arange(n // 2 + 1, device=dev, dtype=torch.float32)
    y = ar.float() - c
    z0 = torch.fft.rfft(canvas, dim=-1)                     # shared
    a = -torch.tan(angles / 2.0)
    b = torch.sin(angles)
    ph_a = _phase(n, k[None, None, :], (a[:, None] * y[None, :])[:, :, None])
    ph_b = _phase(n, k[None, :, None], (b[:, None] * y[None, :])[:, None, :])
    y1 = torch.fft.irfft(ph_a * z0[None], n=n, dim=-1)     # shear 1
    z2 = torch.fft.rfft(y1, dim=-2)
    y2 = torch.fft.irfft(ph_b * z2, n=n, dim=-2) * keep    # shear 2 + guard
    z3 = torch.fft.rfft(y2, dim=-1)
    return torch.conj(torch.fft.fft(ph_a * z3, dim=-2))    # shear 3 ∘ rfft2


def _peak(corr: torch.Tensor, pad: int):
    """argmax over (..., R, pad, pad) → (r, dy, dx, peak), each (...), with
    the signed wrap of shifts; ties take the first index."""
    flat = corr.reshape(corr.shape[:-2] + (-1,))
    arg = flat.argmax(-1)                                   # (..., R)
    per_rot = flat.amax(-1)
    r = per_rot.argmax(-1)                                  # (...)
    pos = arg.gather(-1, r[..., None])[..., 0]
    dy = torch.div(pos, pad, rounding_mode="floor")
    dx = pos % pad
    dy = torch.where(dy > pad // 2, dy - pad, dy)
    dx = torch.where(dx > pad // 2, dx - pad, dx)
    return r, dy, dx, per_rot.gather(-1, r[..., None])[..., 0]


def _peak_ratio(corr: torch.Tensor, peak: torch.Tensor, dy: torch.Tensor,
                dx: torch.Tensor, pad: int, excl: int = 3) -> torch.Tensor:
    """peak / strongest value outside ±excl cells of the peak's shift, over
    all rotations. corr (K, R, pad, pad); peak, dy, dx (K,)."""
    ar = torch.arange(pad, device=corr.device)
    cdy = (ar[None, :] - (dy % pad)[:, None]).abs()          # (K, pad)
    cdx = (ar[None, :] - (dx % pad)[:, None]).abs()
    near_y = torch.minimum(cdy, pad - cdy) <= excl
    near_x = torch.minimum(cdx, pad - cdx) <= excl
    near = near_y[:, :, None] & near_x[:, None, :]           # (K, pad, pad)
    sec = torch.where(near[:, None], -torch.inf, corr).amax(dim=(1, 2, 3))
    return peak / sec.clamp_min(1e-6)


def match_bev_topk(query: BEVImage, db_images: torch.Tensor,
                   db_origins: torch.Tensor, cfg, resolution=None
                   ) -> MatchResult:
    """Register one query against K candidate BEV images.

    query.image (S, S) and query.origin_xy (2,); db_images (K, S, S) float
    (free = 1.0); db_origins (K, 2). Returns a MatchResult with a leading K
    axis; callers take the first success in candidate order."""
    _check_supported(cfg)
    dev = db_images.device
    f32 = dict(dtype=torch.float32, device=dev)
    res = torch.tensor(float(query.resolution if resolution is None
                             else resolution), **f32)
    occ_q = _occupancy(torch.as_tensor(query.image, **f32))
    o_q0 = torch.as_tensor(query.origin_xy, **f32)
    db_origins = torch.as_tensor(db_origins, **f32)
    k_cand = db_images.shape[0]
    occ_db = _occupancy(db_images)

    # ---- shared: coarse rotation stack --------------------------------
    f = cfg.coarse_downsample
    fr = max(cfg.coarse_rot_downsample or f, f)
    cq_r = _maxpool(occ_q, fr)
    sc_r = cq_r.shape[-1]
    pad_c = max(1 << (sc_r - 1).bit_length(), sc_r + sc_r // 2)
    angles_c = (torch.arange(cfg.num_rotations, **f32)
                * (2.0 * math.pi / cfg.num_rotations))
    rot_cp = torch.zeros((cfg.num_rotations, pad_c, pad_c), **f32)
    rot_cp[:, :sc_r, :sc_r] = _rotate_image_shear(cq_r[None], angles_c)
    fr_c = torch.conj(torch.fft.rfft2(rot_cp))

    # ---- shared: fine delta-fan on the FFT canvas ---------------------
    half = cfg.refine_span_deg * math.pi / 180.0 / 2.0
    rf = cfg.refine_rotations
    g = cfg.fine_downsample
    fq = _maxpool(occ_q, g) if g > 1 else occ_q
    sf = fq.shape[-1]
    nf_q = fq.sum()
    pad_f = _good_fft_size(sf + max(cfg.fine_pad_px // g, 16))
    res_f = res * g
    o_q = o_q0 + res * (g - 1) / 2.0
    # 0-centred fan: always contains delta = 0
    deltas = ((torch.arange(rf, device=dev) - rf // 2)
              * (half / max(rf // 2, 1)))
    ffan = _fan_rfft2(fq, deltas, pad_f, float(half))

    # ---- stage 1: coarse angle of every candidate ---------------------
    tgt = torch.zeros((k_cand, pad_c, pad_c), **f32)
    tgt[:, :sc_r, :sc_r] = _maxpool(occ_db, fr)
    corr_c = torch.fft.irfft2(fr_c[None] * torch.fft.rfft2(tgt)[:, None],
                              s=(pad_c, pad_c))              # (K, R, ., .)
    r_c = _peak(corr_c, pad_c)[0]
    theta_c = angles_c[r_c]                                   # (K,)

    # ---- stage 3: fine registration of every candidate ----------------
    fdb = _maxpool(occ_db, g) if g > 1 else occ_db
    nf_db = fdb.sum(dim=(-2, -1))
    tgt_f = torch.zeros((k_cand, pad_f, pad_f), **f32)
    tgt_f[:, :sf, :sf] = _rotate_image_shear(fdb, -theta_c)
    corr_f = torch.fft.irfft2(ffan[None] * torch.fft.rfft2(tgt_f)[:, None],
                              s=(pad_f, pad_f))              # (K, rf, ., .)
    r_f, dy, dx, peak = _peak(corr_f, pad_f)
    ratio = (_peak_ratio(corr_f, peak, dy, dx, pad_f)
             if cfg.min_peak_ratio > 0.0 else torch.zeros_like(peak))

    theta = theta_c + deltas[r_f]
    ct, st = torch.cos(theta), torch.sin(theta)
    ctc, stc = torch.cos(theta_c), torch.sin(theta_c)
    center = ((sf - 1) / 2.0) * res_f
    sx, sy = dx.float() * res_f, dy.float() * res_f
    shift_x, shift_y = ctc * sx - stc * sy, stc * sx + ctc * sy
    o_db = db_origins + res * (g - 1) / 2.0
    qx, qy = o_q[0] + center, o_q[1] + center
    tx = o_db[:, 0] + center + shift_x - (ct * qx - st * qy)
    ty = o_db[:, 1] + center + shift_y - (st * qx + ct * qy)
    score = peak / torch.sqrt(nf_q * nf_db).clamp_min(1.0)
    success = ((score >= cfg.min_score) & (peak >= cfg.min_overlap_pixels)
               & (nf_q > 0) & (nf_db > 0))
    if cfg.min_peak_ratio > 0.0:
        success = success & (ratio >= cfg.min_peak_ratio)
    return MatchResult(
        xy_yaw=torch.stack([tx, ty, torch.atan2(st, ct)], dim=-1),
        score=score, overlap=peak, success=success,
        scale=torch.ones_like(score), ratio=ratio)


def match_bev(query: BEVImage, db: BEVImage, cfg) -> MatchResult:
    """Register query onto one db image: the K = 1 case of match_bev_topk."""
    images = torch.as_tensor(db.image, dtype=torch.float32)[None]
    res = match_bev_topk(query, images, torch.as_tensor(
        db.origin_xy, dtype=torch.float32)[None], cfg,
        resolution=db.resolution)
    return MatchResult(*(x[0] for x in res))
