"""BEV registration by rotation × translation FFT search, plain PyTorch.

A frozen copy of the matcher the serving preset runs
(``fast_match(fm=True)``): the coarse angle of each candidate from a
Fourier-Mellin polar signature of the magnitude spectra (period π, the
180° ambiguity settled by correlating two rotations of the query), the F
best candidates by coarse score registered at the fine grid, where a small
fan of rotations around the coarse angle picks the yaw at a further ÷2 and
one full-θ rotation of the query gives the correlation peak. Rotations are
three FFT shears on a √2 canvas. The output is the metric (dx, dy, yaw)
taking query points to db points, the normalised correlation score and
the score / overlap gate. Options the serving preset leaves off are
refused.

``rnd`` is applied to every FFT's output: the identity, or the control's
rounding to a lower precision.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


def identity(x: Tensor) -> Tensor:
    return x


class Match(NamedTuple):
    xy_yaw: Tensor
    score: Tensor
    overlap: Tensor
    success: Tensor


class _FFT:
    def __init__(self, rnd: Callable[[Tensor], Tensor]):
        self.rnd = rnd

    def __getattr__(self, name):
        fn = getattr(torch.fft, name)
        return lambda *a, **kw: self.rnd(fn(*a, **kw))


def _good_fft_size(n: int) -> int:
    m = n
    while True:
        r = m
        for p in (2, 3, 5, 7):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 1


def _maxpool(img: Tensor, f: int) -> Tensor:
    s = img.shape[-1] // f
    x = img[..., : s * f, : s * f].reshape(img.shape[:-2] + (s, f, s, f))
    return x.amax(dim=(-3, -1))


def _embed(img: Tensor, pad: int) -> Tensor:
    s = img.shape[-1]
    out = img.new_zeros(img.shape[:-2] + (pad, pad))
    out[..., :s, :s] = img
    return out


def _phase(n: int, k: Tensor, shift: Tensor) -> Tensor:
    ang = (torch.tensor(-2.0 * math.pi / n, dtype=torch.float32,
                        device=k.device) * k) * shift
    return torch.polar(torch.ones_like(ang), ang)


def _shear_x(fft, img: Tensor, s: Tensor) -> Tensor:
    n = img.shape[-1]
    dev = img.device
    f = fft.rfft(img, dim=-1)
    k = torch.arange(n // 2 + 1, device=dev, dtype=torch.float32)
    y = (torch.arange(img.shape[-2], device=dev, dtype=torch.float32)
         - (img.shape[-2] - 1) / 2.0)
    sy = s[..., None] * y
    return fft.irfft(f * _phase(n, k, sy[..., :, None]), n=n, dim=-1)


def _rotate(fft, img: Tensor, angles: Tensor) -> Tensor:
    """(..., S, S) images rotated about their centres by (..., R) angles
    → (..., R, S, S): 90° steps by rot90, the rest by three shears."""
    s = img.shape[-1]
    lead = img.shape[:-2]
    pad = _good_fft_size(int(math.ceil(s * math.sqrt(2.0))) + 2)
    while (pad - s) % 2:
        pad = _good_fft_size(pad + 1)
    off = (pad - s) // 2
    img = img.reshape((-1, s, s))
    angles = angles.reshape((img.shape[0], -1))
    canvas = img.new_zeros((img.shape[0], pad, pad))
    canvas[:, off: off + s, off: off + s] = img
    quarter = math.pi / 2.0
    turns = torch.round(angles / quarter)
    k90 = turns.long() % 4
    residual = angles - turns * quarter
    rots = torch.stack([canvas, torch.rot90(canvas, -1, dims=(-2, -1)),
                        torch.rot90(canvas, 2, dims=(-2, -1)),
                        torch.rot90(canvas, 1, dims=(-2, -1))], 1)
    which = torch.arange(img.shape[0], device=img.device)[:, None]
    base = rots[which, k90]
    a = -torch.tan(residual / 2.0)
    b = torch.sin(residual)
    out = _shear_x(fft, _shear_x(fft, base, a).transpose(-1, -2), b
                   ).transpose(-1, -2)
    out = _shear_x(fft, out, a)
    out = out[..., off: off + s, off: off + s].clamp(0.0, 1.0)
    return out.reshape(lead + out.shape[1:])


def _fan_rfft2(fft, img: Tensor, angles: Tensor, pad: int,
               max_abs: float) -> Tensor:
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
    z0 = fft.rfft(canvas, dim=-1)[..., None, :, :]
    a = -torch.tan(angles / 2.0)
    b = torch.sin(angles)
    ph_a = _phase(n, k[None, None, :], (a[:, None] * y[None, :])[:, :, None])
    ph_b = _phase(n, k[None, :, None], (b[:, None] * y[None, :])[:, None, :])
    y1 = fft.irfft(ph_a * z0, n=n, dim=-1)
    z2 = fft.rfft(y1, dim=-2)
    y2 = fft.irfft(ph_b * z2, n=n, dim=-2) * keep
    z3 = fft.rfft(y2, dim=-1)
    return torch.conj(fft.fft(ph_a * z3, dim=-2))


def _polar_weights(s: int, t_bins: int, r_min: int):
    theta = (np.arange(t_bins, dtype=np.float64) + 0.5) * np.pi / t_bins
    radii = np.arange(r_min, s // 2, dtype=np.float64)
    kx = radii[None, :] * np.cos(theta)[:, None]
    ky = radii[None, :] * np.sin(theta)[:, None]
    flip = kx < 0
    kx = np.where(flip, -kx, kx)
    ky = np.where(flip, -ky, ky)
    row = np.mod(ky, s)
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


def _signature(fft, img: Tensor, t_bins: int, r_min: int = 3) -> Tensor:
    s = img.shape[-1]
    dev = img.device
    c = (s - 1) / 2.0
    yy = torch.arange(s, dtype=torch.float32, device=dev) - c
    rad = torch.sqrt(yy[:, None] ** 2 + yy[None, :] ** 2)
    win = torch.where(rad <= s / 2.0,
                      0.5 * (1.0 + torch.cos(math.pi * rad / (s / 2.0))),
                      0.0)
    mag = fft.rfft2(img * win).abs()
    row_w, col_w, n_rad = _polar_weights(s, t_bins, r_min)
    row_w = torch.from_numpy(row_w).to(dev)
    col_w = torch.from_numpy(col_w).to(dev)
    interp = torch.matmul(row_w, mag)
    sig = (interp * col_w).sum(-1).reshape(img.shape[:-2] + (t_bins, n_rad))
    sig = sig - sig.mean(dim=-2, keepdim=True)
    radii = torch.arange(r_min, s // 2, dtype=torch.float32, device=dev)
    return sig * (radii / radii[-1])


def _peak(corr: Tensor, pad: int):
    flat = corr.reshape(corr.shape[:-2] + (-1,))
    arg = flat.argmax(-1)
    per_rot = flat.amax(-1)
    r = per_rot.argmax(-1)
    pos = arg.gather(-1, r[..., None])[..., 0]
    dy = torch.div(pos, pad, rounding_mode="floor")
    dx = pos % pad
    dy = torch.where(dy > pad // 2, dy - pad, dy)
    dx = torch.where(dx > pad // 2, dx - pad, dx)
    return r, dy, dx, per_rot.gather(-1, r[..., None])[..., 0]


def _coarse(fft, occ_q: Tensor, occ_db: Tensor, m: dict):
    b, k_cand = occ_db.shape[:2]
    f = m["coarse_downsample"]
    fr = max(m["coarse_rot_downsample"] or f, f)
    cq_r = _maxpool(occ_q, fr)
    sc_r = cq_r.shape[-1]
    pad_c = max(1 << (sc_r - 1).bit_length(), sc_r + sc_r // 2)
    cdb = _maxpool(occ_db, fr)
    ft_db = fft.rfft2(_embed(cdb, pad_c))
    t = m["fm_theta_bins"]
    fsig_q = torch.conj(fft.rfft(_signature(fft, _maxpool(occ_q, f), t),
                                 dim=-2))
    sig_db = _signature(fft, _maxpool(occ_db, f), t)
    corr_t = fft.irfft(fsig_q[:, None] * fft.rfft(sig_db, dim=-2), n=t,
                       dim=-2).sum(-1)
    delta = corr_t.argmax(-1).float() * (math.pi / t)
    two = _rotate(fft, cq_r, torch.stack([delta, delta + math.pi], -1
                                         ).reshape(b, 2 * k_cand))
    f_two = torch.conj(fft.rfft2(_embed(two, pad_c)))
    corr = fft.irfft2(f_two.reshape((b, k_cand, 2) + f_two.shape[-2:])
                      * ft_db[:, :, None], s=(pad_c, pad_c))
    r2, _, _, peak_c = _peak(corr, pad_c)
    theta_c = delta + r2.float() * math.pi
    return theta_c, peak_c * torch.rsqrt(cdb.sum((-2, -1)).clamp_min(1.0))


def _fine(fft, occ_q, o_q0, res, occ_db, db_origins, theta_c, m) -> Match:
    dev = occ_q.device
    half = m["refine_span_deg"] * math.pi / 180.0 / 2.0
    rf = m["refine_rotations"]
    g = m["fine_downsample"]
    fq = _maxpool(occ_q, g) if g > 1 else occ_q
    sf = fq.shape[-1]
    nf_q = fq.sum((-2, -1))[:, None]
    pad_f = _good_fft_size(sf + max(m["fine_pad_px"] // g, 16))
    res_f = res * g
    o_q = o_q0 + res * (g - 1) / 2.0
    deltas = ((torch.arange(rf, device=dev) - rf // 2)
              * (half / max(rf // 2, 1)))
    fdb = _maxpool(occ_db, g) if g > 1 else occ_db
    nf_db = fdb.sum(dim=(-2, -1))
    g2 = g * int(m["fine_argmax_downsample"])
    fq2 = _maxpool(occ_q, g2)
    pad_f2 = _good_fft_size(fq2.shape[-1] + max(m["fine_pad_px"] // g2, 8))
    ffan2 = _fan_rfft2(fft, fq2, deltas, pad_f2, float(half))
    db2 = _rotate(fft, _maxpool(occ_db, g2),
                  -theta_c[..., None])[..., 0, :, :]
    corr2 = fft.irfft2(ffan2[:, None]
                       * fft.rfft2(_embed(db2, pad_f2))[:, :, None],
                       s=(pad_f2, pad_f2))
    theta_w = theta_c + deltas[corr2.flatten(-2).amax(-1).argmax(-1)]
    f_src = torch.conj(fft.rfft2(_embed(_rotate(fft, fq, theta_w), pad_f)))
    ft_db = fft.rfft2(_embed(fdb, pad_f))
    corr_f = fft.irfft2(f_src * ft_db, s=(pad_f, pad_f))[:, :, None]
    r_f, dy, dx, peak = _peak(corr_f, pad_f)
    score = peak / torch.sqrt(nf_q * nf_db).clamp_min(1.0)
    success = ((score >= m["min_score"]) & (peak >= m["min_overlap_pixels"])
               & (nf_q > 0) & (nf_db > 0))
    theta = theta_w
    ct, st = torch.cos(theta), torch.sin(theta)
    center = ((sf - 1) / 2.0) * res_f
    sx, sy = dx.float() * res_f, dy.float() * res_f
    o_db = db_origins + res * (g - 1) / 2.0
    qx, qy = o_q[:, 0:1] + center, o_q[:, 1:2] + center
    tx = o_db[..., 0] + center + sx - (ct * qx - st * qy)
    ty = o_db[..., 1] + center + sy - (st * qx + ct * qy)
    return Match(torch.stack([tx, ty, torch.atan2(st, ct)], dim=-1),
                 score, peak, success)


def check_preset(m: dict) -> None:
    """The reference covers the serving preset only."""
    want = dict(coarse_mode="fm", overlap_norm=False, min_peak_ratio=0.0)
    bad = {k: m[k] for k, v in want.items() if m[k] != v}
    if bad or int(m["fine_argmax_downsample"]) <= 1:
        raise ValueError(f"the reference matcher covers fast_match(fm=True)"
                         f" only; got {bad or m['fine_argmax_downsample']}")


def match(q_images: Tensor, q_origins: Tensor, db_images: Tensor,
          db_origins: Tensor, m: dict, resolution: float,
          rnd: Callable[[Tensor], Tensor] = identity) -> Match:
    """B query images (B, S, S) with origins (B, 2) against K candidates
    each (B, K, S, S), (B, K, 2) → (B, K) lanes; images free = 1.0."""
    check_preset(m)
    fft = _FFT(rnd)
    dev = db_images.device
    res = torch.tensor(float(resolution), dtype=torch.float32, device=dev)
    occ_q = (q_images < 0.5).float()
    occ_db = (db_images < 0.5).float()
    b, k_cand = db_images.shape[:2]
    theta_c, coarse = _coarse(fft, occ_q, occ_db, m)
    top_f = m["fine_top_f"]
    if not 0 < top_f < k_cand:
        return _fine(fft, occ_q, q_origins, res, occ_db, db_origins, theta_c,
                     m)
    best = torch.sort(coarse, dim=-1, descending=True, stable=True).indices
    sel = torch.sort(best[:, :top_f], dim=-1).values
    rows = torch.arange(b, device=dev)[:, None]
    fine = _fine(fft, occ_q, q_origins, res, occ_db[rows, sel],
                 db_origins[rows, sel], theta_c.gather(-1, sel), m)
    f32 = dict(dtype=torch.float32, device=dev)
    out = Match(torch.zeros((b, k_cand, 3), **f32),
                torch.zeros((b, k_cand), **f32),
                torch.zeros((b, k_cand), **f32),
                torch.zeros((b, k_cand), dtype=torch.bool, device=dev))
    for lane, value in zip(out, fine):
        lane[rows, sel] = value
    return out


def bf16_complex(x: Tensor) -> Tensor:
    """The control's rounding of an FFT's output: each component to
    bfloat16 and back."""
    if x.is_complex():
        return torch.complex(x.real.bfloat16().float(),
                             x.imag.bfloat16().float())
    return x.bfloat16().float()
