"""The system under test: one ``gloc3d_tpu_torch.pipeline.GlobalLocalizer``
as the serving path runs it (ground alignment, the device keyframe store
without a host mirror, the configuration's model with its BatchNorms
folded, ``fast_match(fm=True)``, top-k on the flat fp32 bank), its map,
and the calls the window drives: ``locate_fused`` one query at a time, or
``locate_batch`` of a batch. The localizer's ground draws are reseeded
before every call, so the reference can draw the same numbers.
"""

from __future__ import annotations

import gc
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from lbench import world
from lbench.check import Answer, MapState
from lbench.reference.pose import quat_matrix

# draw-seed streams
MAP, WARM, WINDOW, TRACE, SYNCS = range(5)


class Unit(NamedTuple):
    index: int
    pool: List[int]            # the queries' places in the pool
    draw_seed: int
    seconds: float             # host clock, call to returned results
    answers: Optional[List[Answer]]  # None: the call raised


def answer(res) -> Answer:
    """A ``LocalizationResult`` as the check reads it."""
    rot = trans = None
    if res.pose is not None:
        rot = quat_matrix(np.asarray(res.pose.rotation, np.float64))
        trans = np.asarray(res.pose.translation, np.float64)
    return Answer(bool(res.success), int(res.db_index),
                  np.asarray(res.candidates), np.asarray(res.candidate_dists),
                  float(res.match_score),
                  None if res.match_xy_yaw is None
                  else np.asarray(res.match_xy_yaw, np.float64), rot, trans)


def serving_config(cfg: dict, map_rows: int):
    """The port's PipelineConfig of the configuration's tree, its bank
    sized to the map."""
    from gloc3d_tpu_torch.config import PipelineConfig

    pcfg = PipelineConfig.from_dict(cfg)
    return pcfg.replace(index=pcfg.index.replace(capacity=map_rows))


class Program:
    def __init__(self, cfg: dict, params: dict, scene: world.Scene,
                 traffic: dict, seed: int, device, filler: torch.Tensor):
        from gloc3d_tpu_torch.convert import fold_batch_norm
        from gloc3d_tpu_torch.models.descriptor import build_model
        from gloc3d_tpu_torch.pipeline import GlobalLocalizer, Keyframe

        self.scene, self.traffic, self.seed = scene, traffic, seed
        self.batch = traffic["batch"]
        self.fused = traffic["entry"] == "locate_fused"
        if traffic["entry"] not in ("locate_fused", "locate_batch") or (
                self.fused and self.batch != 1):
            raise ValueError(f"entry {traffic['entry']!r} with batch "
                             f"{self.batch}: locate_fused takes one query, "
                             f"locate_batch any batch")
        m = traffic["map"]
        pcfg = serving_config(cfg, m["keyframes"])
        model = build_model(pcfg.model, pcfg.voxel)
        model.load_state_dict(fold_batch_norm(
            {k: v.cpu() for k, v in params.items()}))
        self.loc = loc = GlobalLocalizer(
            pcfg, model, device=device, align_ground=True,
            device_keyframes=True, host_mirror=False)
        n_real = len(scene.kf_scans)
        self.n_real = n_real
        step = m["build_batch"]
        for j, lo in enumerate(range(0, n_real, step)):
            loc._gen.manual_seed(world.draw_seed(seed, MAP, j))
            loc.add_keyframes(scene.kf_scans[lo:lo + step],
                              scene.kf_masks[lo:lo + step])
        loc.bank.add(filler)
        loc._ensure_kf_capacity(m["keyframes"], pcfg.bev.image_size)
        loc.keyframes.extend([Keyframe(None, None, None)]
                             * (m["keyframes"] - n_real))
        pool = traffic["pool"]
        self.n_off = pool["off_map"]
        self.every = pool["off_map_every"]
        # a batch's scans are gathered into the same host buffers each
        # call: no fresh 16 MB allocation (and its page faults) a batch
        self._scans = np.empty((self.batch,) + scene.q_scans.shape[1:],
                               scene.q_scans.dtype)
        self._masks = np.empty((self.batch,) + scene.q_masks.shape[1:],
                               scene.q_masks.dtype)

    # ------------------------------------------------------------ calls
    def call(self, pool: List[int], draw_seed: int) -> List[Answer]:
        loc, s = self.loc, self.scene
        loc._gen.manual_seed(draw_seed)
        if self.fused:
            p = pool[0]
            return [answer(loc.locate_fused(s.q_scans[p], s.q_masks[p]))]
        np.take(s.q_scans, pool, axis=0, out=self._scans)
        np.take(s.q_masks, pool, axis=0, out=self._masks)
        return [answer(r) for r in loc.locate_batch(self._scans,
                                                    self._masks)]

    def units(self, stream: int):
        """The units of ``stream``: (index, pool places), endless."""
        n = 4096 * self.batch
        order = world.schedule(self.seed * 31 + stream, self.scene.n_on,
                               self.n_off, self.every, n)
        i = 0
        while True:
            j = i % (n // self.batch)
            yield i, order[j * self.batch:(j + 1) * self.batch]
            i += 1

    def run_unit(self, stream: int, index: int, pool: List[int]) -> Unit:
        seed = world.draw_seed(self.seed, stream, index)
        t0 = time.perf_counter()
        try:
            answers = self.call(pool, seed)
        except (RuntimeError, ValueError):
            answers = None
        return Unit(index, pool, seed, time.perf_counter() - t0, answers)

    def run_count(self, stream: int, count: int) -> List[Unit]:
        it = self.units(stream)
        return [self.run_unit(stream, *next(it)) for _ in range(count)]

    def warm_up(self) -> None:
        """Both programs of ``locate_fused`` (captured on the first call)
        and their replays, or ``locate_batch`` with every count of off-map
        queries (0 to the batch), so that stage 2's shapes are settled."""
        n_on = self.scene.n_on
        if self.fused:
            pools = [[i % n_on] for i in range(self.traffic["warmup_units"])]
            pools[1] = [n_on]
            pools[-1] = [n_on + 1 if self.n_off > 1 else n_on]
        else:
            b = self.batch
            pools = [[n_on + (i % self.n_off) if i < j else (i * 7 + j) % n_on
                      for i in range(b)] for j in range(b + 1)]
        for i, pool in enumerate(pools):
            u = self.run_unit(WARM, i, pool)
            if u.answers is None:
                self.call(pool, u.draw_seed)  # raise it here, in set-up

    def window(self, seconds: float):
        """Units back to back until ``seconds`` have passed: (units, the
        window's seconds from its first call to its last result)."""
        out = []
        it = self.units(WINDOW)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            out.append(self.run_unit(WINDOW, *next(it)))
        return out, time.perf_counter() - t0

    # ------------------------------------------------------------ state
    def map_state(self) -> MapState:
        loc, r = self.loc, self.n_real
        images, origins = loc._candidates(np.arange(r))
        ground_q = np.stack([np.asarray(k.ground.rotation, np.float64)
                             for k in loc.keyframes[:r]])
        ground_t = np.stack([np.asarray(k.ground.translation, np.float64)
                             for k in loc.keyframes[:r]])
        return MapState(loc.bank.data.clone(), images.clone(),
                        origins.clone(), ground_q, ground_t)

    def close(self) -> None:
        self.loc = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
