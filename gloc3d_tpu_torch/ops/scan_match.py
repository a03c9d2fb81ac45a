"""Correlative scan-to-grid matching (FastCorrelativeScanMatcher2D).

Port of ``gloc3d_tpu/ops/scan_match.py``, ``match_scan_fast_sharded``
included (the rotations split over the ranks of a process group). The
reference runs Olson's real-time correlative matcher as a branch-and-bound
over a sliding-window-max pyramid
(fast_correlative_scan_matcher_2d.cpp); MatchFullSubmap searches 360° over
the whole grid (:248-268). Here, as in JAX, the search is exhaustive and
batched: the θ-rotated scan is scattered into a count image O_θ, and

    score(θ, t) · N = Σ_i P[cell(R_θ p_i) + t] = (O_θ ⋆ P)(t),

one circular cross-correlation per rotation through cuFFT
(``torch.fft.rfft2`` / ``irfft2``), the rotations batched. The decoded pose
is re-scored by an exact gather. ``match_scan_fast`` bounds coarse cells
first and expands the best exactly, with a certificate.

Ties. Probabilities from ``ProbabilityGrid2D.from_bev_image`` take two
values, so exact score ties between shifts are common, and which tied shift
the FFT's round-off favours differs between pocketfft, MKL and cuFFT. The
port keeps JAX's first-maximum argmax and its ``lax.top_k`` order (stable
descending sorts), and is held to JAX as the same optimum: the same score,
and the same pose or a pose that scores the same.

The rotation grid is ``angular_center + jnp.linspace(-hw, hw, R,
endpoint=False)`` in the arithmetic that definition states, in fp32:
``start·(1 − i/R) + stop·(i/R)``, each operation rounded once
(``rotation_grid``). JAX on the CPU compiles that expression with fused
multiply-adds and a reciprocal in place of the division, and its jitted and
eager calls differ from each other by an ulp at some θ; the port's grid is
the same on every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gloc3d_tpu_torch.ops.occupancy import ProbabilityGrid2D, _fdiv

Tensor = torch.Tensor

# Bytes of FFT intermediates one batch of rotations may hold: the exhaustive
# search at the Olson bound (R ≈ 1 600-2 400 at pad 768) holds ~9.5 MB per
# rotation, 15-23 GB unchunked.
_ROTATION_BYTES = 1 << 30


class ScanMatchResult(NamedTuple):
    pose: Tensor   # (3,) [x, y, theta] metric pose of the scan in grid frame
    score: Tensor  # () mean probability at the matched points, in [0, 1]


def olson_angular_step(resolution: float, max_scan_range: float) -> float:
    """Angular step with the sub-cell guarantee
    (correlative_scan_matcher_2d.cpp:47-51)."""
    return math.acos(
        max(1.0 - resolution ** 2 / (2.0 * max_scan_range ** 2), -1.0))


def rotation_grid(num_rotations: int, angular_center: float,
                  angular_halfwidth: float, device) -> Tensor:
    """(R,) fp32 rotations ``center + linspace(-hw, hw, R, endpoint=False)``
    (module docstring), built on ``device`` with no host copy."""
    f = dict(dtype=torch.float32, device=device)
    step = (torch.arange(num_rotations, **f)
            / torch.full((), num_rotations, **f))
    lin = (torch.full((), -angular_halfwidth, **f) * (1 - step)
           + torch.full((), angular_halfwidth, **f) * step)
    return torch.full((), angular_center, **f) + lin


def rotation_chunk_for(pad: int) -> int:
    """Rotations per FFT batch at FFT size ``pad``: ``_ROTATION_BYTES`` over
    one rotation's intermediates (its fp32 count image and correlation,
    pad² each, and its complex64 spectrum and product, pad·(pad/2 + 1)
    each). At pad 768 that is 113 rotations (1 GiB)."""
    per_rotation = 8 * pad * pad + 16 * pad * (pad // 2 + 1)
    return max(1, _ROTATION_BYTES // per_rotation)


def max_pyramid(grid_probs: Tensor, depths: Sequence[int] = (1, 2, 4, 8, 16)
                ) -> Tuple[Tensor, ...]:
    """Sliding-window maxima (PrecomputationGrid2D, fast_...cpp:112-190):
    level w holds at each cell the max over the w×w window anchored there,
    same shape, -inf beyond the bottom and right edges (JAX's
    ``reduce_window`` padding)."""
    out = []
    for w in depths:
        if w == 1:
            out.append(grid_probs)
            continue
        padded = F.pad(grid_probs[None, None], (0, w - 1, 0, w - 1),
                       value=-math.inf)
        out.append(F.max_pool2d(padded, w, stride=1)[0, 0])
    return tuple(out)


def _scatter_counts(points: Tensor, valid: Tensor, size: int,
                    out_size: Optional[int] = None) -> Tensor:
    """Count image of 2-D cell indices (..., N, 2) [col, row] in a
    size×size frame placed at the corner of an out_size×out_size one (the
    FFT pad ring stays zero): (..., out_size, out_size). Dropped lanes go to
    one extra (out_size²+1)-th slot per image, cut off after the scatter.
    The counts are sums of 1.0, exact in any order."""
    if out_size is None:
        out_size = size
    lead = points.shape[:-2]
    b = math.prod(lead)
    cols, rows = points[..., 0], points[..., 1]
    inb = valid & (rows >= 0) & (rows < size) & (cols >= 0) & (cols < size)
    area = out_size * out_size
    flat = torch.where(inb, rows.long() * out_size + cols, area)
    flat = flat.reshape(b, -1) + torch.arange(
        b, device=flat.device)[:, None] * (area + 1)
    img = torch.zeros(b * (area + 1), dtype=torch.float32,
                      device=points.device)
    img.index_add_(0, flat.reshape(-1), inb.reshape(-1).to(torch.float32))
    return img.view(b, area + 1)[:, :area].reshape(
        *lead, out_size, out_size)


def _cells(thetas: Tensor, points_xy: Tensor, origin_xy: Tensor,
           res: float) -> Tuple[Tensor, Tensor]:
    """Grid (col, row) of the scan rotated by each θ: (R, N) int32 each,
    round((R_θ p − origin) / res), half to even as ``jnp.round``."""
    c, s = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]
    px, py = points_xy[None, :, 0], points_xy[None, :, 1]
    x = c * px - s * py
    y = s * px + c * py
    col = torch.round(_fdiv(x - origin_xy[0], res)).to(torch.int32)
    row = torch.round(_fdiv(y - origin_xy[1], res)).to(torch.int32)
    return col, row


def _grid_size(grid: ProbabilityGrid2D) -> int:
    h, w = grid.log_odds.shape
    if h != w:
        raise ValueError(f"square grids only, got {h}x{w}")
    return h


def _take(x: Tensor, i: Tensor) -> Tensor:
    """``x.reshape(-1)[i]`` for a 0-dim device index, as a 0-dim tensor
    (indexing with a 0-dim tensor would read it back to the host)."""
    return x.reshape(-1).index_select(0, i.reshape(1)).reshape(())


def _fft_corr(counts: Tensor, ft: Tensor, pad: int) -> Tensor:
    """Circular cross-correlation of each count image with the grid whose
    rfft2 is ``ft``: irfft2(conj(rfft2(O)) · F(P))."""
    return torch.fft.irfft2(torch.conj(torch.fft.rfft2(counts)) * ft,
                            s=(pad, pad))


def _decode_shift(idx: Tensor, pad: int) -> Tuple[Tensor, Tensor]:
    """(ty, tx) of a flat index into a pad×pad circular correlation, each
    wrapped to (-pad/2, pad/2]."""
    ty, tx = (idx // pad) % pad, idx % pad
    return (torch.where(ty > pad // 2, ty - pad, ty),
            torch.where(tx > pad // 2, tx - pad, tx))


def _coarse_bounds(probs: Tensor, f: int) -> Tensor:
    """The coarse bound grid over Q ∈ [-1, size_c), index Q + 1: each
    coarse cell's largest probability over the 2f×2f fine window at
    f·Q, ((size - 1) // f + 2)². Q = -1 is reachable (q + T = -1 with
    e + s ≥ f lands in the grid), so f zero rows and columns go before the
    grid, and a correlation with it carries a +1 offset."""
    padded = F.pad(F.pad(probs, (f, 0, f, 0)), (0, 2 * f - 1, 0, 2 * f - 1),
                   value=-math.inf)
    pmax = F.max_pool2d(padded[None, None], 2 * f, stride=f)[0, 0]
    return pmax.clamp(min=0.0)


def _coarse_cells(col: Tensor, row: Tensor, f: int) -> Tensor:
    """Coarse (col, row) cells of fine ones, floored: (..., N, 2)."""
    return torch.stack([torch.div(col, f, rounding_mode="floor"),
                        torch.div(row, f, rounding_mode="floor")], -1)


def match_scan(
    grid: ProbabilityGrid2D,
    points_xy: Tensor,
    mask: Tensor,
    num_rotations: int = 256,
    angular_center: float = 0.0,
    angular_halfwidth: float = math.pi,
    pad: Optional[int] = None,
    rotation_chunk: Optional[int] = None,
) -> ScanMatchResult:
    """The (x, y, θ) placing the scan at maximum mean grid probability.

    Full-window search (MatchFullSubmap) at angular_halfwidth = π; narrow
    ``angular_center`` / ``angular_halfwidth`` for local matching (Match).
    points_xy are metric scan-frame (N, 2).

    The circular FFT is exact (no wrapped mass) for |t| ≤ size/2 cells per
    axis; in the band size/2 < |t| ≤ pad − size the decoded shift is
    unique but its FFT score can include wrapped mass. Raise ``pad`` to
    2·size − 1 for full-range exactness. The returned score is always the
    exact gather's.

    ``rotation_chunk`` bounds memory and nothing else: rotations run in
    FFT batches of that many, keeping only each rotation's maximum between
    batches; the optimum is the same. The default is
    ``rotation_chunk_for(pad)`` (1 GiB of intermediates per batch).
    """
    res = grid.resolution
    size = _grid_size(grid)
    dev = grid.log_odds.device
    probs = grid.probabilities()
    n_valid = (mask > 0).sum().to(torch.float32).clamp(min=1.0)
    if pad is None:
        pad = size + size // 2
    if rotation_chunk is None:
        rotation_chunk = rotation_chunk_for(pad)
    thetas = rotation_grid(num_rotations, angular_center, angular_halfwidth,
                           dev)
    ft = torch.fft.rfft2(F.pad(probs, (0, pad - size, 0, pad - size)))

    best, amax = [], []
    for th in thetas.split(rotation_chunk):
        col, row = _cells(th, points_xy, grid.origin_xy, res)
        counts = _scatter_counts(torch.stack([col, row], -1),
                                 (mask > 0)[None], size, out_size=pad)
        b, a = _fft_corr(counts, ft, pad).reshape(len(th), -1).max(-1)
        best.append(b)
        amax.append(a)
    r = torch.argmax(torch.cat(best))
    a = _take(torch.cat(amax), r)
    dy, dx = _decode_shift(a, pad)
    # exact re-score of the decoded pose, the FFT's objective: points whose
    # untranslated cell is in the grid, translated off the grid read 0
    theta = _take(thetas, r)
    col, row = _cells(theta[None], points_xy, grid.origin_xy, res)
    un_inb = ((mask > 0) & (row[0] >= 0) & (row[0] < size)
              & (col[0] >= 0) & (col[0] < size))
    rowt, colt = row[0] + dy, col[0] + dx
    inb = un_inb & (rowt >= 0) & (rowt < size) & (colt >= 0) & (colt < size)
    flat = (rowt * size + colt).clamp(0, size * size - 1)
    raw = torch.where(inb, probs.reshape(-1)[flat], 0.0).sum()
    pose = torch.stack([dx.to(torch.float32) * res,
                        dy.to(torch.float32) * res, theta])
    return ScanMatchResult(pose, raw / n_valid)


def match_scan_fast(
    grid: ProbabilityGrid2D,
    points_xy: Tensor,
    mask: Tensor,
    num_rotations: int = 256,
    angular_center: float = 0.0,
    angular_halfwidth: float = math.pi,
    coarse_factor: int = 4,
    num_candidates: int = 128,
    certificate_slack: float = 0.05,
) -> Tuple[ScanMatchResult, Tensor]:
    """Coarse-to-fine ``match_scan``: the same optimum with ~f²× smaller
    FFTs (the bound of PrecomputationGrid2D, fast_...cpp:112-190, and the
    pruning of BranchAndBound, :192-246, batched).

    1. Coarse bound: ``Pmax[Q]`` = max P over the 2f×2f fine window
       anchored at f·Q. A point at fine cell f·q + e and a translation
       f·T + s (e, s ∈ [0, f)²) land in that window, so Σ_i Pmax[q_i + T]
       bounds the score of every fine t in coarse cell T: one FFT
       correlation per rotation on a grid f× smaller per side.
    2. The ``num_candidates`` best (θ, T) are expanded exactly at their f²
       fine translations (a gather of K·f²·N probabilities).

    Returns ``(result, certificate)``: the certificate is True when the
    best fine score is within ``certificate_slack`` counts of the best
    unexpanded bound, i.e. the result is the global optimum up to a
    slack-count tie. The slack absorbs FFT round-off only. A False
    certificate (loose bounds on grids whose free space is mostly known)
    tells the caller to fall back to ``match_scan``; ``match_full_submap``
    does that.
    """
    thetas = rotation_grid(num_rotations, angular_center, angular_halfwidth,
                           grid.log_odds.device)
    pose, raw, unexpanded_bound, n_valid = _match_fast_core(
        grid, points_xy, mask, thetas, coarse_factor, num_candidates)
    certificate = raw >= unexpanded_bound - certificate_slack
    return ScanMatchResult(pose, raw / n_valid), certificate


def match_scan_fast_sharded(
    mesh,
    grid: ProbabilityGrid2D,
    points_xy: Tensor,
    mask: Tensor,
    num_rotations: int = 256,
    angular_center: float = 0.0,
    angular_halfwidth: float = math.pi,
    coarse_factor: int = 4,
    num_candidates: int = 128,
    certificate_slack: float = 0.05,
    axis: Optional[str] = None,
) -> Tuple[ScanMatchResult, Tensor]:
    """``match_scan_fast`` with the rotations split over the ranks of the
    process group ``mesh`` (None: the default group; ``axis`` names JAX's
    mesh axis, a process group has one). Every rank calls it with the same
    arguments (SPMD). Rank r takes the r-th contiguous slice of the θ grid,
    runs the coarse FFT and the top-K expansion on its rotations alone, and
    one all-gather of every rank's (pose, best raw score, best unexpanded
    bound) merges them: the winner is the first maximum in rank order, as
    JAX's ``argmax`` picks it, and the certificate holds when its score is
    within ``certificate_slack`` of the largest bound. Every coarse cell
    lies in one slice, so the certificate stays exact; each rank expands
    its own top K, so it certifies at least as often as the unsharded
    call. Every rank returns the same ``(result, certificate)``."""
    from gloc3d_tpu_torch.parallel.collectives import all_gather, group_shape

    world, rank = group_shape(mesh)
    if num_rotations % world:
        raise ValueError(
            f"num_rotations ({num_rotations}) must divide the mesh axis "
            f"({world}); round up to a multiple")
    thetas = rotation_grid(num_rotations, angular_center, angular_halfwidth,
                           grid.log_odds.device)
    per = num_rotations // world
    pose, raw, bound, n_valid = _match_fast_core(
        grid, points_xy, mask, thetas[rank * per:(rank + 1) * per],
        coarse_factor, num_candidates)
    parts = all_gather(mesh, torch.cat([pose, raw[None], bound[None]]))
    best = torch.argmax(parts[:, 3])
    best_raw = parts[best, 3]
    certificate = best_raw >= parts[:, 4].max() - certificate_slack
    return ScanMatchResult(parts[best, :3], best_raw / n_valid), certificate


def _top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _match_fast_core(
    grid: ProbabilityGrid2D,
    points_xy: Tensor,
    mask: Tensor,
    thetas: Tensor,
    coarse_factor: int,
    num_candidates: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Coarse-bound FFT and top-K exact expansion over the rotations
    ``thetas``: (pose, best raw score in counts, best unexpanded bound,
    n_valid)."""
    res = grid.resolution
    size = _grid_size(grid)
    f = coarse_factor
    size_c = (size - 1) // f + 1
    pad_c = size_c + size_c // 2
    dev = grid.log_odds.device
    probs = grid.probabilities()
    n_valid = (mask > 0).sum().to(torch.float32).clamp(min=1.0)
    valid = mask > 0

    # the coarse bound grid; its +1 offset is removed at decode
    pmax = _coarse_bounds(probs, f)                # (size_c + 1)²
    ft_c = torch.fft.rfft2(F.pad(pmax, (0, pad_c - size_c - 1,
                                        0, pad_c - size_c - 1)))

    bounds = []
    for th in thetas.split(rotation_chunk_for(pad_c)):
        col, row = _cells(th, points_xy, grid.origin_xy, res)
        # match_scan's drop rule: a point whose untranslated fine cell is
        # off the grid contributes nothing
        inb = (valid & (row >= 0) & (row < size) & (col >= 0)
               & (col < size))
        q = _coarse_cells(col, row, f)
        bounds.append(_fft_corr(_scatter_counts(q, inb, size_c,
                                                out_size=pad_c), ft_c, pad_c))
    flat_bounds = torch.cat(bounds).reshape(-1)

    # Hierarchical selection, as JAX: per-block maxima → the best blocks →
    # the best cells of the pooled blocks. A cell not selected is bounded
    # by max(block_bound, pool_bound), so the certificate is unchanged.
    block = 128
    n = flat_bounds.numel()
    nblk = -(-n // block)
    flat_bounds = F.pad(flat_bounds, (0, nblk * block - n),
                        value=-math.inf)
    blk_max = flat_bounds.view(nblk, block).amax(1)
    nb_sel = min(num_candidates, nblk)
    btop, bidx = _top_k(blk_max, min(nb_sel + 1, nblk))
    neg_inf = torch.full((), -math.inf, device=dev)
    block_bound = btop[nb_sel] if nblk > nb_sel else neg_inf
    pool_idx = (bidx[:nb_sel, None] * block
                + torch.arange(block, device=dev)[None, :]).reshape(-1)
    pool = flat_bounds[pool_idx]
    ncand = min(num_candidates, pool.numel())
    top, pidx = _top_k(pool, min(ncand + 1, pool.numel()))
    cand = pool_idx[pidx[:ncand]]
    pool_bound = top[ncand] if pool.numel() > ncand else neg_inf
    unexpanded_bound = torch.maximum(pool_bound, block_bound)
    r_k = cand // (pad_c * pad_c)
    ty_c, tx_c = _decode_shift(cand, pad_c)
    ty_c, tx_c = ty_c - 1, tx_c - 1

    # exact fine scores at the K candidates × f² fine translations, one
    # (K, N) gather per fine translation
    th_k = thetas[r_k]
    col_k, row_k = _cells(th_k, points_xy, grid.origin_xy, res)   # (K, N)
    w_k = (valid[None] & (row_k >= 0) & (row_k < size)
           & (col_k >= 0) & (col_k < size))
    p_flat = probs.reshape(-1)
    ty = (f * ty_c[:, None]
          + torch.arange(f, device=dev).repeat_interleave(f)[None])  # (K, f²)
    tx = f * tx_c[:, None] + torch.arange(f, device=dev).repeat(f)[None]
    scores = []
    for j in range(f * f):
        rows_t = row_k + ty[:, j:j + 1]
        cols_t = col_k + tx[:, j:j + 1]
        inb_t = (w_k & (rows_t >= 0) & (rows_t < size) & (cols_t >= 0)
                 & (cols_t < size))
        flat = (rows_t * size + cols_t).clamp(0, size * size - 1)
        scores.append(torch.where(inb_t, p_flat[flat], 0.0).sum(-1))
    scores = torch.stack(scores, 1)                                # (K, f²)

    best = torch.argmax(scores.reshape(-1))
    raw = _take(scores, best)
    pose = torch.stack([_take(tx, best).to(torch.float32) * res,
                        _take(ty, best).to(torch.float32) * res,
                        _take(th_k, best // (f * f))])
    return pose, raw, unexpanded_bound, n_valid


def score_at(
    grid: ProbabilityGrid2D,
    points_xy: Tensor,
    mask: Tensor,
    pose: Tensor,
) -> Tensor:
    """Exact mean-probability score of the scan placed at ``pose`` (x, y,
    θ), the quantity both matchers maximise, by a gather. The translation
    is rounded to whole cells apart from the rotated points, as in JAX."""
    res = grid.resolution
    size = grid.log_odds.shape[0]
    probs = grid.probabilities()
    n_valid = (mask > 0).sum().to(torch.float32).clamp(min=1.0)
    col, row = _cells(pose[2:3], points_xy, grid.origin_xy, res)
    col = col[0] + torch.round(_fdiv(pose[0], res)).to(torch.int32)
    row = row[0] + torch.round(_fdiv(pose[1], res)).to(torch.int32)
    inb = (mask > 0) & (row >= 0) & (row < size) & (col >= 0) & (col < size)
    flat = (row * size + col).clamp(0, size * size - 1)
    return torch.where(inb, probs.reshape(-1)[flat], 0.0).sum() / n_valid


class SubmapMatchResult(NamedTuple):
    pose: Tensor        # (3,) [x, y, theta]
    score: Tensor       # () mean probability
    certified: bool     # fast-path certificate (True ⇒ optimum, no fallback)
    used_fallback: bool


def match_full_submap(
    grid: ProbabilityGrid2D,
    points_xy: Tensor,
    mask: Tensor,
    num_rotations: Optional[int] = None,
    max_scan_range: float = 50.0,
    angular_center: float = 0.0,
    angular_halfwidth: float = math.pi,
    coarse_factor: int = 4,
    num_candidates: Optional[int] = None,
    fallback: str = "full",
    try_fast: Optional[bool] = None,
) -> SubmapMatchResult:
    """MatchFullSubmap with the certificate → fallback policy
    (fast_correlative_scan_matcher_2d.cpp:248-268), as JAX's.

    ``num_rotations`` defaults to the Olson bound over the window
    (``olson_angular_step(resolution, max_scan_range)``);
    ``num_candidates`` to max(128, min(R, 2048)); ``try_fast`` to R ≤ 512
    (above it the certificate held in 0/20 realistic queries in JAX's
    measurements, so the fast attempt only adds cost). The certificate is
    read once on the host:

    - certified → the fast result is the global optimum (up to the
      0.05-count tie of ``match_scan_fast``);
    - else ``fallback="full"``: exhaustive ``match_scan`` over the same
      window; ``"theta"``: exhaustive over 7 rotations in ±3·δθ of the fast
      pose's θ, the better of the two returned, not certified exact;
      ``"none"``: the fast result, certified False.
    """
    if num_rotations is None:
        step = olson_angular_step(grid.resolution, max_scan_range)
        num_rotations = max(1, int(math.ceil(2 * angular_halfwidth / step)))
    if num_candidates is None:
        num_candidates = max(128, min(num_rotations, 2048))
    if try_fast is None:
        try_fast = num_rotations <= 512
    if not try_fast:
        exact = match_scan(grid, points_xy, mask, num_rotations,
                           angular_center, angular_halfwidth)
        return SubmapMatchResult(exact.pose, exact.score, False, True)
    fast, cert = match_scan_fast(
        grid, points_xy, mask, num_rotations, angular_center,
        angular_halfwidth, coarse_factor, num_candidates)
    if bool(cert):
        return SubmapMatchResult(fast.pose, fast.score, True, False)
    if fallback == "none":
        return SubmapMatchResult(fast.pose, fast.score, False, False)
    if fallback == "theta":
        step = 2 * angular_halfwidth / num_rotations
        nb = match_scan(grid, points_xy, mask, 7, float(fast.pose[2]),
                        3.0 * step)
        res = nb if float(nb.score) > float(fast.score) else fast
        return SubmapMatchResult(res.pose, res.score, False, True)
    if fallback != "full":
        raise ValueError(f"unknown fallback policy {fallback!r}")
    exact = match_scan(grid, points_xy, mask, num_rotations,
                       angular_center, angular_halfwidth)
    return SubmapMatchResult(exact.pose, exact.score, False, True)
