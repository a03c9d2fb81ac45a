"""BEV registration by exhaustive rotation × translation FFT search.

Port of ``gloc3d_tpu/ops/bev_match.py`` (``match_bev_topk``, ``match_bev``)
with ``torch.fft`` (cuFFT on the card), every ``MatchConfig`` option
included:

- the coarse angle of every candidate, from a max-pooled rotation stack of
  the query (three-shear FFT rotations) correlated against the candidate
  (``coarse_mode="stack"``), or from the Fourier-Mellin estimator
  (``"fm"``): a 1-D correlation of translation-invariant polar magnitude
  signatures, whose 180° ambiguity two rotations settle;
- ``fine_top_f``: only the F best candidates by coarse score are
  registered; the others report success False, score 0 and scale 1;
- the fine stage: a small rotation fan around each candidate's coarse
  angle, correlated at full resolution (or /``fine_downsample``). With
  ``fine_argmax_downsample > 1`` the fan only picks the yaw, at a further
  downsample, and one full-θ rotation of the query against the unrotated
  candidate gives the peak;
- ``overlap_norm``: the peak is the masked NCC over the overlap region,
  with shifts whose overlap mass is under ``min_overlap_pixels`` at −1.

Output contract: metric (dx, dy, yaw) taking query points to db points, a
normalised correlation score, and the score / overlap accept gate.

The query and candidate axes are batch dimensions here: one call registers
B queries against K candidates each, as ``jax.vmap(match_bev_topk)`` does
in the JAX package, and the one-query call is its B = 1 case. The JAX
package's ``optimization_barrier`` calls and its ``lax.map`` FFT batch
chunking are XLA workarounds and are not ported.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from gloc3d_tpu_torch.core.device import device_constant
from gloc3d_tpu_torch.ops.bev import BEVImage


class MatchResult(NamedTuple):
    """Rigid 2-D registration of a query BEV image onto db BEV images."""

    xy_yaw: torch.Tensor   # (..., 3) [dx, dy, yaw]: p_db = R(yaw)·p_q + t
    score: torch.Tensor    # (...) normalised correlation peak
    overlap: torch.Tensor  # (...) occupied-pixel overlap at the peak
    success: torch.Tensor  # (...) bool: clears the score and overlap gates
    scale: torch.Tensor    # (...) 1.0 (rigid)
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


def _occupancy(img: torch.Tensor) -> torch.Tensor:
    """BEV image (free=1, occupied=0) → binary occupancy (occupied=1)."""
    return (img < 0.5).float()


def _maxpool(img: torch.Tensor, f: int) -> torch.Tensor:
    s = img.shape[-1] // f
    x = img[..., : s * f, : s * f].reshape(img.shape[:-2] + (s, f, s, f))
    return x.amax(dim=(-3, -1))


def _embed(img: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., S, S) images at the top left of (..., pad, pad) zeros."""
    s = img.shape[-1]
    out = img.new_zeros(img.shape[:-2] + (pad, pad))
    out[..., :s, :s] = img
    return out


def _phase(n: int, k: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """exp(−2πi/n · k · shift) in complex64, k and shift broadcast."""
    ang = (device_constant(-2.0 * math.pi / n, torch.float32, k.device)
           * k) * shift
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
    """Rotate (..., S, S) images about their centres, each by its own
    angles (..., R) → (..., R, S, S); the leading axes match.

    Exact 90° steps by ``rot90`` plus the residual (|θ| ≤ 45°) as three FFT
    shears on a √2-sized canvas, then cropped and clipped to [0, 1]."""
    s = img.shape[-1]
    lead = img.shape[:-2]
    pad = _good_fft_size(int(math.ceil(s * math.sqrt(2.0))) + 2)
    while (pad - s) % 2:  # exact centre alignment needs even (pad − s)
        pad = _good_fft_size(pad + 1)
    off = (pad - s) // 2
    img = img.reshape((-1, s, s))
    angles = angles.reshape((img.shape[0], -1))            # (L, R)
    canvas = img.new_zeros((img.shape[0], pad, pad))
    canvas[:, off : off + s, off : off + s] = img

    quarter = math.pi / 2.0
    turns = torch.round(angles / quarter)
    k90 = turns.long() % 4
    residual = angles - turns * quarter
    # rot90 turns axis 0 toward axis 1: a MATH-NEGATIVE rotation in the
    # (row = y, col = x) image convention, so +90° steps use k = −1
    rots = torch.stack([canvas,
                        torch.rot90(canvas, -1, dims=(-2, -1)),
                        torch.rot90(canvas, 2, dims=(-2, -1)),
                        torch.rot90(canvas, 1, dims=(-2, -1))], 1)
    which = torch.arange(img.shape[0], device=img.device)[:, None]
    base = rots[which, k90]                                 # (L, R, pad, pad)
    a = -torch.tan(residual / 2.0)
    b = torch.sin(residual)
    out = _shear_x_fft(_shear_x_fft(base, a).transpose(-1, -2), b
                       ).transpose(-1, -2)
    out = _shear_x_fft(out, a)
    out = out[..., off : off + s, off : off + s].clamp(0.0, 1.0)
    return out.reshape(lead + out.shape[1:])


def _fan_rfft2(img: torch.Tensor, angles: torch.Tensor, pad: int,
               max_abs: float) -> torch.Tensor:
    """``conj(rfft2(``small-angle rotation fan of (..., S, S) ``img`` on a
    (pad, pad) top-left canvas``))`` → (..., R, pad, pad//2+1) complex64,
    every image by the same R ``angles``, with the shear FFTs fused into
    the correlation FFT (see the JAX docstring for the guard band that
    keeps the circular wrap out)."""
    s = img.shape[-1]
    n = pad
    dev = img.device
    canvas = _embed(img, pad)
    c = (s - 1) / 2.0
    guard = s + (pad - s) // 2
    drift3 = int(math.ceil(math.tan(max_abs / 2.0) * (s / 2.0))) + 1
    ar = torch.arange(pad, device=dev)
    keep = ((ar < guard)[:, None] & (ar < guard - drift3)[None, :]).float()
    k = torch.arange(n // 2 + 1, device=dev, dtype=torch.float32)
    y = ar.float() - c
    z0 = torch.fft.rfft(canvas, dim=-1)[..., None, :, :]    # shared
    a = -torch.tan(angles / 2.0)
    b = torch.sin(angles)
    ph_a = _phase(n, k[None, None, :], (a[:, None] * y[None, :])[:, :, None])
    ph_b = _phase(n, k[None, :, None], (b[:, None] * y[None, :])[:, None, :])
    y1 = torch.fft.irfft(ph_a * z0, n=n, dim=-1)           # shear 1
    z2 = torch.fft.rfft(y1, dim=-2)
    y2 = torch.fft.irfft(ph_b * z2, n=n, dim=-2) * keep    # shear 2 + guard
    z3 = torch.fft.rfft(y2, dim=-1)
    return torch.conj(torch.fft.fft(ph_a * z3, dim=-2))    # shear 3 ∘ rfft2


def _polar_weights(s: int, t_bins: int, r_min: int):
    """Bilinear polar-resampling weights over a (s, s//2+1) rFFT magnitude
    → (RowW (P, s), ColW (P, s//2+1), n_radii), P = t_bins · n_radii: the
    resample is ``RowW @ mag`` and a weighted column sum. The port's copy
    of the JAX package's numpy function."""
    theta = (np.arange(t_bins, dtype=np.float64) + 0.5) * np.pi / t_bins
    radii = np.arange(r_min, s // 2, dtype=np.float64)
    kx = radii[None, :] * np.cos(theta)[:, None]
    ky = radii[None, :] * np.sin(theta)[:, None]
    flip = kx < 0                                     # |F(-k)| = |F(k)|
    kx = np.where(flip, -kx, kx)
    ky = np.where(flip, -ky, ky)
    row = np.mod(ky, s)                               # signed freq → row
    r0 = np.floor(row).astype(np.int64)
    c0 = np.floor(kx).astype(np.int64)
    fr_ = (row - r0).ravel()
    fc = (kx - c0).ravel()
    p = t_bins * len(radii)
    i = np.arange(p)
    row_w = np.zeros((p, s), np.float32)
    row_w[i, (r0 % s).ravel()] += 1.0 - fr_
    row_w[i, ((r0 + 1) % s).ravel()] += fr_
    col_w = np.zeros((p, s // 2 + 1), np.float32)
    col_w[i, np.clip(c0, 0, s // 2).ravel()] += 1.0 - fc
    col_w[i, np.clip(c0 + 1, 0, s // 2).ravel()] += fc
    return row_w, col_w, len(radii)


def _polar_weights_on(s: int, t_bins: int, r_min: int,
                      device: torch.device):
    """``_polar_weights`` as tensors on ``device``, built once per shape
    (a copy made under a fake tensor mode is not kept)."""
    key = (s, t_bins, r_min, torch.device(device))
    out = _POLAR_WEIGHTS.get(key)
    if out is None:
        row_w, col_w, n_rad = _polar_weights(s, t_bins, r_min)
        out = (torch.from_numpy(row_w).to(device),
               torch.from_numpy(col_w).to(device), n_rad)
        if all(type(t) is torch.Tensor for t in out[:2]):
            _POLAR_WEIGHTS[key] = out
    return out


_POLAR_WEIGHTS: dict = {}


@contextlib.contextmanager
def _ieee_matmul():
    """fp32 matmuls without TF32 inside: TF32 rounding moves a 1° argmax
    over 180 signature bins."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _angular_signature(img: torch.Tensor, t_bins: int, r_min: int = 3
                       ) -> torch.Tensor:
    """Fourier-Mellin rotation signature of (..., s, s) images → (..., T, R).

    Polar resampling of the Hann-windowed magnitude spectrum: a rotation by
    θ circularly shifts the signature by θ along T (period π, hence the
    caller's 180° check). The per-radius mean over θ is removed and radii
    are weighted linearly."""
    s = img.shape[-1]
    dev = img.device
    c = (s - 1) / 2.0
    yy = torch.arange(s, dtype=torch.float32, device=dev) - c
    rad = torch.sqrt(yy[:, None] ** 2 + yy[None, :] ** 2)
    win = torch.where(rad <= s / 2.0,
                      0.5 * (1.0 + torch.cos(math.pi * rad / (s / 2.0))),
                      0.0)
    mag = torch.fft.rfft2(img * win).abs()              # (..., s, s//2+1)
    row_w, col_w, n_rad = _polar_weights_on(s, t_bins, r_min, dev)
    with _ieee_matmul():
        interp = torch.matmul(row_w, mag)               # (..., P, s//2+1)
    sig = (interp * col_w).sum(-1).reshape(img.shape[:-2] + (t_bins, n_rad))
    sig = sig - sig.mean(dim=-2, keepdim=True)
    radii = torch.arange(r_min, s // 2, dtype=torch.float32, device=dev)
    return sig * (radii / radii[-1])


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
    all rotations. corr (..., R, pad, pad); peak, dy, dx (...)."""
    ar = torch.arange(pad, device=corr.device)
    cdy = (ar - (dy % pad)[..., None]).abs()                 # (..., pad)
    cdx = (ar - (dx % pad)[..., None]).abs()
    near_y = torch.minimum(cdy, pad - cdy) <= excl
    near_x = torch.minimum(cdx, pad - cdx) <= excl
    near = near_y[..., :, None] & near_x[..., None, :]       # (..., pad, pad)
    sec = torch.where(near[..., None, :, :], -torch.inf, corr).amax(
        dim=(-3, -2, -1))
    return peak / sec.clamp_min(1e-6)


def _coarse(occ_q: torch.Tensor, occ_db: torch.Tensor, cfg):
    """Every candidate's coarse angle θ_c (B, K) and its coarse score
    (B, K): the coarse peak over the square root of the candidate's pooled
    mass, which ranks candidates for ``fine_top_f``. occ_q (B, S, S),
    occ_db (B, K, S, S)."""
    b, k_cand = occ_db.shape[:2]
    f = cfg.coarse_downsample
    fr = max(cfg.coarse_rot_downsample or f, f)
    cq_r = _maxpool(occ_q, fr)                               # (B, ., .)
    sc_r = cq_r.shape[-1]
    pad_c = max(1 << (sc_r - 1).bit_length(), sc_r + sc_r // 2)
    cdb = _maxpool(occ_db, fr)
    ft_db = torch.fft.rfft2(_embed(cdb, pad_c))              # (B, K, ., .)
    if cfg.coarse_mode == "fm":
        # |F| is translation-invariant and rotates with the image: one
        # polar signature per image replaces the rotation stack, and the
        # θ-correlation (period π) is 1-D
        t = cfg.fm_theta_bins
        fsig_q = torch.conj(torch.fft.rfft(
            _angular_signature(_maxpool(occ_q, f), t), dim=-2))
        sig_db = _angular_signature(_maxpool(occ_db, f), t)  # (B, K, T, R)
        corr_t = torch.fft.irfft(fsig_q[:, None]
                                 * torch.fft.rfft(sig_db, dim=-2),
                                 n=t, dim=-2).sum(-1)        # (B, K, T)
        delta = corr_t.argmax(-1).float() * (math.pi / t)
        # the 180° ambiguity: two rotations per candidate, checked densely
        two = _rotate_image_shear(cq_r, torch.stack(
            [delta, delta + math.pi], -1).reshape(b, 2 * k_cand))
        f_two = torch.conj(torch.fft.rfft2(_embed(two, pad_c)))
        corr = torch.fft.irfft2(
            f_two.reshape((b, k_cand, 2) + f_two.shape[-2:])
            * ft_db[:, :, None], s=(pad_c, pad_c))           # (B, K, 2, ., .)
        r2, _, _, peak_c = _peak(corr, pad_c)
        theta_c = delta + r2.float() * math.pi
    else:
        angles_c = (torch.arange(cfg.num_rotations, dtype=torch.float32,
                                 device=occ_q.device)
                    * (2.0 * math.pi / cfg.num_rotations))
        fr_c = torch.conj(torch.fft.rfft2(_embed(_rotate_image_shear(
            cq_r, angles_c.expand(b, -1)), pad_c)))          # (B, R, ., .)
        corr = torch.fft.irfft2(fr_c[:, None] * ft_db[:, :, None],
                                s=(pad_c, pad_c))            # (B, K, R, ., .)
        r_c, _, _, peak_c = _peak(corr, pad_c)
        theta_c = angles_c[r_c]
    return theta_c, peak_c * torch.rsqrt(cdb.sum((-2, -1)).clamp_min(1.0))


def _fine(occ_q: torch.Tensor, o_q0: torch.Tensor, res: torch.Tensor,
          occ_db: torch.Tensor, db_origins: torch.Tensor,
          theta_c: torch.Tensor, cfg) -> MatchResult:
    """Fine registration of B queries (occ_q (B, S, S), o_q0 (B, 2))
    against K candidates each (occ_db (B, K, S, S), db_origins (B, K, 2))
    at their coarse angles theta_c (B, K) → (B, K) lanes."""
    dev = occ_q.device
    b, k_cand = occ_db.shape[:2]
    half = cfg.refine_span_deg * math.pi / 180.0 / 2.0
    rf = cfg.refine_rotations
    g = cfg.fine_downsample
    fq = _maxpool(occ_q, g) if g > 1 else occ_q
    sf = fq.shape[-1]
    nf_q = fq.sum((-2, -1))[:, None]                         # (B, 1)
    pad_f = _good_fft_size(sf + max(cfg.fine_pad_px // g, 16))
    res_f = res * g
    o_q = o_q0 + res * (g - 1) / 2.0
    # 0-centred fan: always contains delta = 0
    deltas = ((torch.arange(rf, device=dev) - rf // 2)
              * (half / max(rf // 2, 1)))
    fdb = _maxpool(occ_db, g) if g > 1 else occ_db
    nf_db = fdb.sum(dim=(-2, -1))                            # (B, K)
    cs = (pad_f, pad_f)
    two_stage = int(cfg.fine_argmax_downsample) > 1
    if two_stage:
        # the fan only picks the yaw, at a further /fa; then one full-θ
        # rotation of the query against the UNROTATED db gives the peak,
        # whose shift is already in the db frame
        g2 = g * int(cfg.fine_argmax_downsample)
        fq2 = _maxpool(occ_q, g2)
        pad_f2 = _good_fft_size(fq2.shape[-1]
                                + max(cfg.fine_pad_px // g2, 8))
        ffan2 = _fan_rfft2(fq2, deltas, pad_f2, float(half))  # (B, rf, ., .)
        db2 = _rotate_image_shear(_maxpool(occ_db, g2),
                                  -theta_c[..., None])[..., 0, :, :]
        corr2 = torch.fft.irfft2(
            ffan2[:, None]
            * torch.fft.rfft2(_embed(db2, pad_f2))[:, :, None],
            s=(pad_f2, pad_f2))                              # (B, K, rf, ., .)
        theta_w = theta_c + deltas[corr2.flatten(-2).amax(-1).argmax(-1)]
        f_src = torch.conj(torch.fft.rfft2(_embed(
            _rotate_image_shear(fq, theta_w), pad_f)))       # (B, K, ., .)
        ft_db = torch.fft.rfft2(_embed(fdb, pad_f))
        corr_f = torch.fft.irfft2(f_src * ft_db, s=cs)[:, :, None]
        thetas_r = theta_w[..., None]
        rot_c = torch.zeros_like(theta_c)
    else:
        ffan = _fan_rfft2(fq, deltas, pad_f, float(half))    # (B, rf, ., .)
        ft_db = torch.fft.rfft2(_embed(_rotate_image_shear(
            fdb, -theta_c[..., None])[..., 0, :, :], pad_f))  # (B, K, ., .)
        corr_f = torch.fft.irfft2(ffan[:, None] * ft_db[:, :, None], s=cs)
        thetas_r = theta_c[..., None] + deltas
        rot_c = theta_c

    if cfg.overlap_norm:
        # per-shift occupancy masses inside the overlap region: the db's
        # under the rotated query support, the query's under the db's; the
        # supports of all B·K angles rotate as one batch
        ones = torch.ones((sf, sf), device=dev)
        if two_stage:
            q_sup = _rotate_image_shear(ones, theta_w.reshape(-1)).reshape(
                b, k_cand, sf, sf)
            m_q = torch.fft.irfft2(
                f_src * torch.fft.rfft2(_embed(ones, pad_f)), s=cs)[:, :, None]
            m_db = torch.fft.irfft2(torch.conj(torch.fft.rfft2(
                _embed(q_sup, pad_f))) * ft_db, s=cs)[:, :, None]
        else:
            db_sup = _rotate_image_shear(ones, -theta_c.reshape(-1)).reshape(
                b, k_cand, sf, sf)
            m_q = torch.fft.irfft2(ffan[:, None] * torch.fft.rfft2(
                _embed(db_sup, pad_f))[:, :, None], s=cs)
            m_db = torch.fft.irfft2(
                _fan_rfft2(ones, deltas, pad_f, float(half))
                * ft_db[:, :, None], s=cs)
        ncc = corr_f * torch.rsqrt(m_q.clamp_min(1.0) * m_db.clamp_min(1.0))
        score_map = torch.where(
            torch.minimum(m_q, m_db) >= float(cfg.min_overlap_pixels),
            ncc, -1.0)
        r_f, dy, dx, score = _peak(score_map, pad_f)
        at = (r_f * pad_f + dy % pad_f) * pad_f + dx % pad_f
        peak = corr_f.flatten(-3).gather(-1, at[..., None])[..., 0]
        ratio_of = score_map
        # score > -1: at least one shift met the mass floor
        success = (score >= cfg.min_score) & (score > -1.0)
    else:
        r_f, dy, dx, peak = _peak(corr_f, pad_f)
        score = peak / torch.sqrt(nf_q * nf_db).clamp_min(1.0)
        ratio_of = corr_f
        success = ((score >= cfg.min_score)
                   & (peak >= cfg.min_overlap_pixels))
    # the ratio is a full extra max over the volume: only for its gate
    ratio = (_peak_ratio(ratio_of, score if cfg.overlap_norm else peak,
                         dy, dx, pad_f)
             if cfg.min_peak_ratio > 0.0 else torch.zeros_like(peak))
    success = success & (nf_q > 0) & (nf_db > 0)
    if cfg.min_peak_ratio > 0.0:
        success = success & (ratio >= cfg.min_peak_ratio)

    theta = thetas_r.gather(-1, r_f[..., None])[..., 0]
    ct, st = torch.cos(theta), torch.sin(theta)
    ctc, stc = torch.cos(rot_c), torch.sin(rot_c)
    center = ((sf - 1) / 2.0) * res_f
    sx, sy = dx.float() * res_f, dy.float() * res_f
    shift_x, shift_y = ctc * sx - stc * sy, stc * sx + ctc * sy
    o_db = db_origins + res * (g - 1) / 2.0
    qx, qy = o_q[:, 0:1] + center, o_q[:, 1:2] + center
    tx = o_db[..., 0] + center + shift_x - (ct * qx - st * qy)
    ty = o_db[..., 1] + center + shift_y - (st * qx + ct * qy)
    return MatchResult(
        xy_yaw=torch.stack([tx, ty, torch.atan2(st, ct)], dim=-1),
        score=score, overlap=peak, success=success,
        scale=torch.ones_like(score), ratio=ratio)


def match_bev_topk(query: BEVImage, db_images: torch.Tensor,
                   db_origins: torch.Tensor, cfg, resolution=None
                   ) -> MatchResult:
    """Register queries against K candidate BEV images each.

    One query: query.image (S, S) and query.origin_xy (2,), db_images
    (K, S, S) float (free = 1.0), db_origins (K, 2) → a MatchResult with a
    leading K axis. A batch of B queries, in one call: query.image
    (B, S, S), query.origin_xy (B, 2), db_images (B, K, S, S), db_origins
    (B, K, 2) → (B, K) lanes. Callers take the first success in candidate
    order."""
    dev = db_images.device
    f32 = dict(dtype=torch.float32, device=dev)
    res = device_constant(float(query.resolution if resolution is None
                                else resolution), torch.float32, dev)
    occ_q = _occupancy(torch.as_tensor(query.image, **f32))
    o_q0 = torch.as_tensor(query.origin_xy, **f32)
    db_origins = torch.as_tensor(db_origins, **f32)
    one = occ_q.ndim == 2
    if one:
        occ_q, o_q0 = occ_q[None], o_q0[None]
        db_images, db_origins = db_images[None], db_origins[None]
    b, k_cand = db_images.shape[:2]
    occ_db = _occupancy(db_images)

    theta_c, coarse_score = _coarse(occ_q, occ_db, cfg)
    if not 0 < cfg.fine_top_f < k_cand:
        out = _fine(occ_q, o_q0, res, occ_db, db_origins, theta_c, cfg)
    else:
        # each query's F best by coarse score, ties to the earlier
        # candidate (as lax.top_k), registered in candidate order and
        # written back into its (B, K) lanes
        best = torch.sort(coarse_score, dim=-1, descending=True,
                          stable=True).indices
        sel = torch.sort(best[:, : cfg.fine_top_f], dim=-1).values
        rows = torch.arange(b, device=dev)[:, None]
        fine = _fine(occ_q, o_q0, res, occ_db[rows, sel],
                     db_origins[rows, sel], theta_c.gather(-1, sel), cfg)
        out = MatchResult(
            xy_yaw=torch.zeros((b, k_cand, 3), **f32),
            score=torch.zeros((b, k_cand), **f32),
            overlap=torch.zeros((b, k_cand), **f32),
            success=torch.zeros((b, k_cand), dtype=torch.bool, device=dev),
            scale=torch.ones((b, k_cand), **f32),
            ratio=torch.zeros((b, k_cand), **f32))
        for lane, value in zip(out, fine):
            lane[rows, sel] = value
    return MatchResult(*(x[0] for x in out)) if one else out


def match_bev(query: BEVImage, db: BEVImage, cfg) -> MatchResult:
    """Register query onto one db image: the K = 1 case of match_bev_topk."""
    images = torch.as_tensor(db.image, dtype=torch.float32)[None]
    res = match_bev_topk(query, images, torch.as_tensor(
        db.origin_xy, dtype=torch.float32)[None], cfg,
        resolution=db.resolution)
    return MatchResult(*(x[0] for x in res))
