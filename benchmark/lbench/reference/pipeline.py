"""The located query, plain PyTorch: ground → aligned scan → BEV image and
descriptor → exact top-k over the map → first-success-wins registration,
the top candidate first and all K when it fails → 6-DoF pose.

``Reference(cfg, params, device, precision)`` holds one configuration (the
JSON tree of the configuration file's ``pipeline``) and the unfolded
weights. ``precision="exact"`` computes what the configuration states:
float64 ground, float32 networks, search and registration. ``"control"``
computes one step below each: float32 ground, the networks' products in
fp8 (e4m3), the search in bfloat16 and every FFT rounded to bfloat16.
TF32 is switched off while the reference runs.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from lbench.reference import bev, ground, match, models, pose


@contextlib.contextmanager
def ieee_fp32():
    """float32 products and convolutions without TF32 inside."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


class Reference:
    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 device, precision: str = "exact"):
        if precision not in ("exact", "control"):
            raise ValueError(f"precision {precision!r}")
        self.cfg, self.p, self.device = cfg, params, torch.device(device)
        control = precision == "control"
        self.q = models.fp8 if control else models.identity
        self.rnd = match.bf16_complex if control else match.identity
        self.rows = _bf16 if control else models.identity
        self.gdtype = torch.float32 if control else torch.float64
        self.i2i = cfg["model"]["encoder"] != "pointpillar"

    # ------------------------------------------------------------ extraction
    @torch.no_grad()
    def extract(self, points: np.ndarray, masks: np.ndarray,
                draw_seed: int, block: int = 8) -> dict:
        """Scans (B, N, 4) and masks (B, N) whose ground draws come from a
        generator seeded with ``draw_seed`` → per scan: ground (rotation,
        translation), BEV image and origin, descriptor; computed in blocks
        of ``block`` scans (the draws in the batch's order)."""
        cfg, dev = self.cfg, self.device
        b, n = points.shape[:2]
        prio, uni = ground.ground_draws(b, n, cfg["ground"]["ransac_iters"],
                                        torch.Generator().manual_seed(
                                            int(draw_seed)))
        out: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("rot", "trans", "image", "origin", "desc")}
        with ieee_fp32():
            for lo in range(0, b, block):
                sl = slice(lo, lo + block)
                pts = torch.as_tensor(points[sl], device=dev)
                msk = torch.as_tensor(masks[sl], device=dev)
                rot, trans = ground.estimate_ground(
                    pts[..., :3], msk, cfg["ground"], prio[sl], uni[sl],
                    self.gdtype)
                aligned = ground.align(pts, rot, trans)
                image, origin = bev.scan_to_bev(aligned[..., :3], msk,
                                                cfg["bev"])
                inputs = image if self.i2i else aligned
                desc = models.descriptor(self.p, cfg["model"], cfg["voxel"],
                                         inputs, msk, self.q)
                for k, v in zip(out, (rot, trans, image, origin, desc)):
                    out[k].append(v)
        return {k: torch.cat(v) for k, v in out.items()}

    # ------------------------------------------------------------ map
    def build_map(self, scans: np.ndarray, masks: np.ndarray,
                  draw_seeds: List[int], batch: int,
                  filler: torch.Tensor) -> dict:
        """The map's real keyframes, extracted in batches of ``batch`` with
        one draw seed each, then the filler rows of the bank (their store
        images empty)."""
        parts = [self.extract(scans[lo:lo + batch], masks[lo:lo + batch],
                              seed)
                 for lo, seed in zip(range(0, len(scans), batch), draw_seeds)]
        m = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        m["bank"] = torch.cat([m["desc"].float(),
                               filler.to(self.device).float()])
        return m

    def search(self, desc: torch.Tensor, bank: torch.Tensor, k: int):
        """(Q, D) descriptors → (d2 (Q, k) ascending, ids (Q, k)), ties to
        the lower row; and every row's d2 (Q, N)."""
        with ieee_fp32():
            qd, b = self.rows(desc.float()), self.rows(bank)
            d2 = ((qd * qd).sum(-1, keepdim=True) - 2.0 * qd @ b.t()
                  + (b * b).sum(-1)[None])
        d2s, ids = torch.sort(d2, dim=-1, stable=True)
        return d2s[:, :k].clamp_min(0.0), ids[:, :k], d2

    # ------------------------------------------------------------ register
    def _images(self, m: dict, rows: torch.Tensor):
        """Keyframe images and origins at ``rows``; filler rows empty."""
        n_real = m["image"].shape[0]
        real = rows < n_real
        at = rows.clamp_max(n_real - 1)
        images = torch.where(real[..., None, None], m["image"][at], 1.0)
        origins = torch.where(real[..., None], m["origin"][at], 0.0)
        return images, origins

    @torch.no_grad()
    def register(self, q: dict, m: dict, candidates: np.ndarray) -> list:
        """First success wins for B queries (``extract``'s output) against
        their candidate rows (B, K), as the program stages it: every
        query's top candidate in one call, then all K candidates of the
        queries that failed in one more. Returns per query (success,
        db_index, score, xy_yaw, pose)."""
        mc = self.cfg["match"]
        res = self.cfg["bev"]["resolution"]
        rows = torch.as_tensor(candidates, dtype=torch.long,
                               device=self.device)
        n_map = m["bank"].shape[0]
        rows = rows.clamp(0, n_map - 1)
        b, k = rows.shape
        with ieee_fp32():
            img, org = self._images(m, rows[:, :1])
            first = match.match(q["image"], q["origin"], img, org, mc, res,
                                self.rnd)
            lanes = [tuple(x[i].cpu().numpy() for x in first)
                     for i in range(b)]
            failed = [i for i in range(b) if not lanes[i][3][0]]
            if failed and mc["staged_first"]:
                sel = torch.as_tensor(failed, device=self.device)
                img, org = self._images(m, rows[sel])
                full = match.match(q["image"][sel], q["origin"][sel], img,
                                   org, mc, res, self.rnd)
                for j, i in enumerate(failed):
                    lanes[i] = tuple(x[j].cpu().numpy() for x in full)
        out = []
        rows = rows.cpu().numpy()
        for i in range(b):
            xy_yaw, score, _, success = lanes[i]
            if not success.any():
                out.append((False, -1, float(score.max()), None, None))
                continue
            j = int(np.argmax(success))
            db = int(rows[i, j])
            g_q = pose.rigid(q["rot"][i].cpu().numpy(),
                             q["trans"][i].cpu().numpy())
            g_db = None
            if db < m["rot"].shape[0]:
                g_db = pose.rigid(m["rot"][db].cpu().numpy(),
                                  m["trans"][db].cpu().numpy())
            out.append((True, db, float(score[j]), xy_yaw[j],
                        pose.compose_6dof(xy_yaw[j], g_q, g_db)))
        return out

    def locate(self, points: np.ndarray, masks: np.ndarray, draw_seed: int,
               m: dict, candidates: Optional[np.ndarray] = None) -> dict:
        """A batch of queries end to end: extraction, search, and the
        registration of ``candidates`` (the program's, which the reference
        judges) or of its own."""
        q = self.extract(points, masks, draw_seed)
        k = self.cfg["index"]["top_k"]
        d2, ids, all_d2 = self.search(q["desc"], m["bank"], k)
        cand = ids.cpu().numpy() if candidates is None else candidates
        return dict(q=q, d2=d2, ids=ids, all_d2=all_d2,
                    results=self.register(q, m, cand), candidates=cand)
