"""Triplet trainer: cache-refresh mining loop, SGD, checkpoints, early stop.

Port of ``gloc3d_tpu/train/trainer.py``, for the s2s (PointPillar) model
on padded clouds and for the i2i image encoders on (N, S, S, 3) BEV images:

  per epoch, per cache-refresh subset of the queries:
    1. refresh the feature cache: an eval-mode forward over the whole set;
    2. mine a query batch's (positive, ≤ n_neg negatives) on the device;
    3. forward cat(q, pos, negs) in one train-mode batch, backpropagate the
       per-pair triplet loss / number of real negatives, one optimizer step;
  per ``eval_every`` epochs: recall@{1,5,10,20}, the latest and best
  checkpoints, early stop after ``patience`` evaluations without a gain.

Two s2s train paths, as in JAX. The all-device path (``host_stats=False``) bins
on the card: kernel K2 for the pillar statistics and for the feature mean,
whose backward is ``pillar_bin_sums_grad``'s row gather. The host-stats path
bins and pillar-sorts each batch on the host (the native host pass) and
takes the feature mean on kernel K1, backward through
``segment_sum_sorted_grad``. Images take one path: the model is called on
the images alone (masks are None), and ``host_stats`` and ``augment_yaw``
are ignored for them, as in JAX.

Freezing: ``trainable_mask`` (``models/encoders.py::train_mask`` builds the
reference's for a pretrained image encoder) takes a frozen parameter out of
the optimizer (``requires_grad=False``), so neither the update nor the
weight decay or momentum touches it, as JAX's ``optax.masked(set_to_zero)``
leaves it; in train mode a frozen layer's BatchNorm still moves its
running statistics, in both frameworks.

Optimizer: ``torch.optim.SGD(momentum, weight_decay)`` is optax's
``add_decayed_weights`` then ``sgd`` (coupled L2, then momentum). The
learning rate is optax's staircase ``exponential_decay`` over
``lr_step × steps_per_epoch`` optimizer steps: it is set from the count of
steps taken before each step, so skipped batches do not advance it. The
Adam option is plain ``Adam(lr)``: no decay, no schedule.

Random draws (epoch order, negative samples, yaw) come from one CPU
``torch.Generator`` seeded by ``seed``, so the same seed draws the same
numbers on every device; torch cannot replay JAX's streams, so parity tests
inject the batch, triplets and yaw. Checkpoints are ``torch.save`` files
with the ``config.json`` / ``history.json`` of the JAX trainer.

Data parallelism (``mesh``, a process group: JAX's mesh, whose step XLA
keeps global). Every rank runs the same calls (SPMD) and holds the same
state; what JAX's replicated step computes over the whole batch is
computed over the group:

- at construction, rank 0's parameters and buffers are broadcast, and
  every BatchNorm normalises over the group's rows
  (``models/batchnorm.py::set_batchnorm_group``);
- a step takes the whole mined batch on every rank; each rank runs its
  slice by query (its queries, their positives and negatives), its host
  pass binning only those rows, and divides its summed per-pair loss by
  the all-reduced count of real negatives, so the ranks' losses sum to
  the batch's;
- the gradients are then summed over the ranks by explicit all-reduces of
  one flat buffer (not DDP: the step keeps the one-process code path, the
  model keeps its state-dict names, and gloo on CPU tensors runs the same
  code as NCCL), so every rank steps with the batch's gradient and the
  parameters stay bit-equal;
- mining runs on every rank (its draws come from the generator, which
  advances alike everywhere) and rank 0's triplets are broadcast;
- the feature cache is computed in contiguous shares of whole batches and
  all-gathered in rank order;
- checkpoints and ``history.json`` are written by rank 0 behind a barrier.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.data import native
from gloc3d_tpu_torch.eval import recall
from gloc3d_tpu_torch.models.batchnorm import set_batchnorm_group
from gloc3d_tpu_torch.models.losses import training_triplet_loss
from gloc3d_tpu_torch.ops.topk import l2_topk
from gloc3d_tpu_torch.parallel.data import (
    all_reduce_grads, broadcast_module, gather_rows, require_group,
)
from gloc3d_tpu_torch.parallel.collectives import broadcast_rank0, group_shape
from gloc3d_tpu_torch.train.mining import MinedTriplets, mine_triplets


def draw_aug_yaw(generator: Optional[torch.Generator], b: int
                 ) -> torch.Tensor:
    """Per-sample augmentation yaw, uniform in (−π, π), on the CPU."""
    return (torch.rand(b, generator=generator) * 2.0 - 1.0) * math.pi


def rotate_clouds_z(q_in: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Rotate the xy channels of (B, N, ≥ 2) clouds by per-sample ``yaw``;
    the other channels are kept. The same function serves both paths: the
    host-stats path rotates on the CPU before the host pass."""
    yaw = yaw.to(q_in.device, q_in.dtype)
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    x, y = q_in[..., 0], q_in[..., 1]
    rot = torch.stack([c * x - s * y, s * x + c * y], dim=-1)
    return torch.cat([rot, q_in[..., 2:]], dim=-1)


class Trainer:
    """Drives triplet training of a DescriptorModel on a TripletDataset.

    Args:
      cfg: a PipelineConfig (the port's or the JAX package's).
      model: a DescriptorModel with ``fold_bn=False``; moved to
        ``device`` and trained in place.
      dataset, eval_dataset: ``TripletDataset``s (``data/dataset.py``)
        with (N, P, 4) clouds and their prefix-contiguous (N, P) masks, or
        (N, S, S, 3) images and no masks.
      workdir: checkpoints, ``config.json`` and ``history.json``.
      seed: seed of the trainer's generator (default ``cfg.train.seed``).
      mesh: None (one process), or a torch.distributed process group to
        train data-parallel over (``dist.group.WORLD`` for all ranks);
        ``cfg.train.batch_size`` must be a multiple of its size.
      trainable_mask: optional ``{parameter name: bool}``; False freezes the
        parameter (``requires_grad=False``, left out of the optimizer).
      device: where the model, caches and steps run (default ``cuda``;
        without a card, pass ``device="cpu"``).
    """

    def __init__(self, cfg, model, dataset, workdir: str,
                 eval_dataset=None, seed: Optional[int] = None, mesh=None,
                 trainable_mask: Optional[Mapping[str, bool]] = None, *,
                 device=None):
        if mesh is not None:
            mesh = require_group(mesh, "Trainer(mesh=...)")
            world = group_shape(mesh)[0]
            if cfg.train.batch_size % world:
                raise ValueError(
                    f"batch_size {cfg.train.batch_size} must be divisible "
                    f"by the mesh size {world}")
        self.mesh = mesh
        if cfg.model.fold_bn:
            raise ValueError("training needs live BatchNorm: build the "
                             "model with fold_bn=False")
        t = cfg.train
        self.cfg = cfg
        self.ds = dataset
        self.eval_ds = eval_dataset
        self.workdir = workdir
        self.device = resolve_device(device, "Trainer")
        os.makedirs(workdir, exist_ok=True)
        self.model = model.to(self.device)
        if mesh is not None:
            broadcast_module(mesh, self.model)
            set_batchnorm_group(self.model, mesh)
        self.is_s2s = cfg.model.encoder == "pointpillar"
        self.host_stats = bool(t.host_stats) and self.is_s2s
        self.generator = torch.Generator().manual_seed(
            seed if seed is not None else t.seed)

        self.pos_mask = torch.from_numpy(
            dataset.nontrivial_positives(t.nontriv_pos_dist)).to(self.device)
        self.neg_mask = torch.from_numpy(
            dataset.potential_negatives(t.neg_dist_thr)).to(self.device)
        self.neg_cache = torch.zeros((dataset.num_q, t.n_neg),
                                     dtype=torch.long, device=self.device)

        if trainable_mask is not None:
            for name, p in self.model.named_parameters():
                if not trainable_mask.get(name, True):
                    p.requires_grad_(False)
        params = [p for p in self.model.parameters() if p.requires_grad]
        self.adam = t.optimizer.lower() == "adam"
        if self.adam:
            self.optimizer = torch.optim.Adam(params, lr=t.lr)
        else:
            self.optimizer = torch.optim.SGD(
                params, lr=t.lr, momentum=t.momentum,
                weight_decay=t.weight_decay)
        self.transition_steps = t.lr_step * max(dataset.num_q // t.batch_size,
                                                1)
        self.step = 0  # optimizer steps taken
        self.history: list = []
        self.best_recall5 = -1.0
        self.epochs_since_best = 0

    # ------------------------------------------------------------- schedule
    def learning_rate(self) -> float:
        """The rate of the next optimizer step."""
        t = self.cfg.train
        if self.adam:
            return t.lr
        return t.lr * t.lr_gamma ** (self.step // self.transition_steps)

    # --------------------------------------------------------------- forward
    def _tensor(self, a) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def _host_sorted(self, inputs: np.ndarray, masks: np.ndarray):
        """Host pillar stats + counting sort of a numpy scan batch →
        (sorted points, valid, voxel_stats 5-tuple) on the device.

        crop=False keeps out-of-grid rows (zeroed into pillar 0 by the
        model), so the unmasked PointNet BN sees the same rows as on the
        all-device path. Masks must be prefix-contiguous (valid rows first):
        the native pass reads ``masks.sum(1)`` as a prefix length."""
        inputs = np.asarray(inputs, np.float32)
        m = np.asarray(masks, np.float32)
        assert (np.diff(m, axis=1) <= 0).all(), (
            "_host_sorted requires prefix-contiguous masks "
            "(valid rows first); got a mask with a 0->1 transition")
        counts = m.sum(1).astype(np.int64)
        v = self.cfg.voxel
        p, vl, i, c, g, s, pp = native.compute_voxel_stats_host_sorted(
            inputs, counts, v.xbound, v.ybound, v.zbound, crop=False,
            num_threads=8, per_point=True)

        def dev(a):
            return torch.from_numpy(a).to(self.device, non_blocking=True)

        return dev(p), dev(vl), tuple(dev(a) for a in (i, c, g, s, pp))

    @torch.no_grad()
    def compute_cache(self, inputs: np.ndarray, masks: np.ndarray,
                      batch: int = 8) -> torch.Tensor:
        """Eval-mode descriptors (N, D) of a whole set (``masks`` None for
        images), ``batch`` inputs at a time, on the device. (JAX pads the
        tail batch to one jit shape; in eval mode the rows are independent,
        so the port does not.) Data-parallel, each rank runs a contiguous
        share of the batches, and the shares are gathered in rank order:
        every rank holds the same bits, those of the one-process cache."""
        self.model.eval()
        starts = list(range(0, len(inputs), batch))
        if self.mesh is not None:
            world, rank = group_shape(self.mesh)
            per = -(-len(starts) // world)
            starts = starts[rank * per:(rank + 1) * per]
        outs = []
        for i in starts:
            x = inputs[i:i + batch]
            mk = None if masks is None else masks[i:i + batch]
            if self.host_stats:
                p, vl, vs = self._host_sorted(x, mk)
                outs.append(self.model(p, vl, voxel_stats=vs))
            else:
                outs.append(self.model(self._tensor(x), self._tensor(mk)))
        if self.mesh is None:
            return torch.cat(outs)
        # a rank with no batch (fewer batches than ranks) still gathers:
        # the descriptor width comes from the group
        dim = torch.tensor([outs[0].shape[1] if outs else 0],
                           device=self.device)
        torch.distributed.all_reduce(dim, torch.distributed.ReduceOp.MAX,
                                     group=self.mesh)
        local = torch.zeros((per * batch, int(dim.item())),
                            device=self.device)
        if outs:
            mine = torch.cat(outs)
            local[:len(mine)] = mine
        return gather_rows(self.mesh, local)[:len(inputs)]

    # ------------------------------------------------------------ train step
    def _local(self, q_in, q_mk, p_in, p_mk, n_in, n_mk, neg_valid,
               q_valid, yaw=None):
        """This rank's part of a mined batch: its slice of the queries,
        their positives and negatives, ``neg_valid`` and ``q_valid`` rows
        and yaws (numpy or tensors, None kept). Without a mesh, the
        batch."""
        if self.mesh is None:
            return q_in, q_mk, p_in, p_mk, n_in, n_mk, neg_valid, q_valid, yaw
        world, rank = group_shape(self.mesh)
        b, n_neg = len(q_in), self.cfg.train.n_neg
        q = slice(rank * b // world, (rank + 1) * b // world)
        n = slice(q.start * n_neg, q.stop * n_neg)
        return tuple(None if a is None else a[rows] for a, rows in (
            (q_in, q), (q_mk, q), (p_in, q), (p_mk, q), (n_in, n),
            (n_mk, n), (neg_valid, q), (q_valid, q), (yaw, q)))

    def train_step(self, q_in, q_mk, p_in, p_mk, n_in, n_mk, neg_valid,
                   q_valid, yaw=None) -> torch.Tensor:
        """One step on a mined batch: (B, N, 4) queries and positives,
        (B·n_neg, N, 4) negatives, their masks, (B, n_neg) ``neg_valid``
        and (B,) ``q_valid``; or images with masks None. ``yaw`` (B,)
        rotates the query clouds first (ignored for images). On the
        host-stats path the clouds (numpy) are rotated on the host, binned
        by the host pass (``_host_sorted``) and stepped by
        ``train_step_hs``. Data-parallel, every rank passes the whole batch
        and runs its part, its host pass binning only its own rows. Returns
        the batch's loss (a device scalar)."""
        (q_in, q_mk, p_in, p_mk, n_in, n_mk, neg_valid, q_valid,
         yaw) = self._local(q_in, q_mk, p_in, p_mk, n_in, n_mk, neg_valid,
                            q_valid, yaw)
        yaw = (torch.as_tensor(np.array(yaw, np.float32))
               if yaw is not None and self.is_s2s else None)
        if self.host_stats:
            if yaw is not None:  # the pillar assignment must see the rotation
                q_in = rotate_clouds_z(
                    torch.from_numpy(np.asarray(q_in, np.float32)),
                    yaw).numpy()
            return self.train_step_hs(
                *self._host_sorted(np.concatenate([q_in, p_in, n_in]),
                                   np.concatenate([q_mk, p_mk, n_mk])),
                neg_valid, q_valid)
        q = self._tensor(q_in)
        if yaw is not None:
            q = rotate_clouds_z(q, yaw)
        inputs = torch.cat([q, self._tensor(p_in), self._tensor(n_in)])
        masks = (torch.cat([self._tensor(m) for m in (q_mk, p_mk, n_mk)])
                 if self.is_s2s else None)
        return self._step(inputs, masks, None, neg_valid, q_valid)

    def train_step_hs(self, inputs, valid, vs, neg_valid, q_valid
                      ) -> torch.Tensor:
        """Host-stats step on a binned batch: ``inputs`` is the
        concatenated (q | pos | negs) batch, pillar-sorted on the host,
        with its ``valid`` rows and voxel stats (``_host_sorted``); any yaw
        augmentation happened before the host pass. Data-parallel, the
        arguments are this rank's part, binned by its own host pass, as
        ``train_step`` makes them."""
        return self._step(inputs, valid, vs, neg_valid, q_valid)

    def _step(self, inputs, masks, vs, neg_valid, q_valid) -> torch.Tensor:
        """One optimizer step on this rank's (q | pos | negs) batch. With a
        mesh the loss is divided by the group's count of real negatives
        and the gradients (and losses) are summed over the ranks."""
        t = self.cfg.train
        b = inputs.shape[0] // (2 + t.n_neg)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        desc = self.model(inputs, masks, voxel_stats=vs)
        nv = (torch.as_tensor(neg_valid, device=self.device).float()
              * torch.as_tensor(q_valid, device=self.device).float()[:, None])
        count = nv.sum()
        if self.mesh is not None:
            torch.distributed.all_reduce(count, group=self.mesh)
        loss = training_triplet_loss(
            desc[:b], desc[b:2 * b], desc[2 * b:].reshape(b, t.n_neg, -1),
            nv, margin=math.sqrt(t.margin), count=count)
        loss.backward()
        loss = loss.detach().clone()
        if self.mesh is not None:
            all_reduce_grads(self.mesh, self.model.parameters(), loss)
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate()
        self.optimizer.step()
        self.step += 1
        return loss

    # ------------------------------------------------------------ train epoch
    def _train_batch(self, batch_idx: np.ndarray, cache_db: torch.Tensor,
                     cache_q: torch.Tensor) -> Optional[torch.Tensor]:
        """Mine one query batch and take its step; None (no step, the
        schedule does not advance) when no query of the batch is valid."""
        t, ds = self.cfg.train, self.ds
        idx = torch.as_tensor(batch_idx, device=self.device)
        mined = mine_triplets(cache_db, cache_q, idx, self.pos_mask,
                              self.neg_mask, self.neg_cache, t.margin,
                              t.n_neg, t.n_neg_sample,
                              generator=self.generator)
        if self.mesh is not None:
            mined = self._broadcast_mined(mined)
        if not bool(mined.valid.any()):
            return None
        self.neg_cache[idx] = mined.neg_idx
        pos = mined.pos_idx.cpu().numpy()
        neg = mined.neg_idx.cpu().numpy().reshape(-1)
        q_in, p_in, n_in = (ds.q_inputs[batch_idx], ds.db_inputs[pos],
                            ds.db_inputs[neg])
        q_mk, p_mk, n_mk = ((ds.q_masks[batch_idx], ds.db_masks[pos],
                             ds.db_masks[neg]) if self.is_s2s
                            else (None, None, None))
        yaw = (draw_aug_yaw(self.generator, len(batch_idx))
               if t.augment_yaw and self.is_s2s else None)
        return self.train_step(q_in, q_mk, p_in, p_mk, n_in, n_mk,
                               mined.neg_valid, mined.valid.float(), yaw)

    def _broadcast_mined(self, mined: MinedTriplets) -> MinedTriplets:
        """Rank 0's triplets on every rank (one float64 broadcast: the
        indices convert both ways exactly), so that no rank branches or
        steps on other triplets."""
        n_neg = mined.neg_idx.shape[1]
        packed = torch.cat([mined.pos_idx[:, None].double(),
                            mined.neg_idx.double(), mined.neg_valid.double(),
                            mined.valid[:, None].double(),
                            mined.d_pos[:, None].double()], 1)
        broadcast_rank0(self.mesh, packed)
        pos, neg, nv, valid, d_pos = packed.split([1, n_neg, n_neg, 1, 1], 1)
        return MinedTriplets(pos[:, 0].long(), neg.long(),
                             nv.to(mined.neg_valid.dtype), valid[:, 0] > 0.5,
                             d_pos[:, 0].to(mined.d_pos.dtype))

    def train_epoch(self, epoch: int) -> float:
        """One pass over the queries in a random order; returns the mean
        loss of the steps taken (0.0 if none)."""
        t = self.cfg.train
        nq = self.ds.num_q
        order = torch.randperm(nq, generator=self.generator).numpy()
        refresh = t.cache_refresh_rate or nq
        losses = []
        for sub_start in range(0, nq, refresh):
            sub = order[sub_start:sub_start + refresh]
            cache_db = self.compute_cache(self.ds.db_inputs, self.ds.db_masks)
            cache_q = self.compute_cache(self.ds.q_inputs, self.ds.q_masks)
            for i in range(0, len(sub), t.batch_size):
                batch_idx = sub[i:i + t.batch_size]
                if len(batch_idx) < t.batch_size:
                    continue
                loss = self._train_batch(batch_idx, cache_db, cache_q)
                if loss is not None:
                    losses.append(float(loss))
        return float(np.mean(losses)) if losses else 0.0

    # ------------------------------------------------------------------ eval
    def evaluate(self, ds=None) -> Dict[int, float]:
        """recall@{1,5,10,20} (those ≤ the db size) on a dataset."""
        ds = ds or self.eval_ds or self.ds
        cache_db = self.compute_cache(ds.db_inputs, ds.db_masks)
        cache_q = self.compute_cache(ds.q_inputs, ds.q_masks)
        k = min(20, ds.num_db)
        _, idx = l2_topk(cache_q, cache_db, k)
        positives = ds.eval_positives(self.cfg.train.pos_dist_thr)
        ns = [n for n in (1, 5, 10, 20) if n <= k]
        return recall.recall_at_n(idx.cpu().numpy(), positives, ns)

    # ------------------------------------------------------------------- fit
    def fit(self, epochs: Optional[int] = None,
            log: Callable[[str], None] = print):
        """Train up to ``epochs`` (default ``cfg.train.epochs``) with
        evaluation, checkpoints and early stop; returns the model."""
        t = self.cfg.train
        epochs = epochs or t.epochs
        say = log if self._writes() else (lambda _: None)
        for epoch in range(1, epochs + 1):
            avg_loss = self.train_epoch(epoch)
            entry = {"epoch": epoch, "loss": avg_loss}
            if epoch % t.eval_every == 0:
                rec = self.evaluate()
                entry["recall"] = rec
                r5 = rec.get(5, rec.get(1, 0.0))
                self.save_checkpoint("latest")
                if r5 > self.best_recall5:
                    self.best_recall5 = r5
                    self.epochs_since_best = 0
                    self.save_checkpoint("best")
                else:
                    self.epochs_since_best += 1
                say(f"epoch {epoch}: loss {avg_loss:.4f} recall {rec}")
                if t.patience and self.epochs_since_best >= t.patience:
                    say(f"early stop at epoch {epoch} "
                        f"(no recall@5 gain for {t.patience} evals)")
                    break
            else:
                say(f"epoch {epoch}: loss {avg_loss:.4f}")
            self.history.append(entry)
        return self.model

    # ------------------------------------------------------------ checkpoints
    def _ckpt_path(self, tag: str) -> str:
        return os.path.join(self.workdir, f"ckpt_{tag}.pt")

    def _writes(self) -> bool:
        """Whether this process writes files and logs: rank 0 of the mesh,
        or the one process."""
        return self.mesh is None or group_shape(self.mesh)[1] == 0

    def save_checkpoint(self, tag: str) -> None:
        """The model, optimizer and step as ``ckpt_<tag>.pt``, with
        ``config.json`` and ``history.json``; data-parallel, rank 0 writes
        (every rank holds the same state) and the ranks meet after."""
        if self._writes():
            torch.save({"model": self.model.state_dict(),
                        "optimizer": self.optimizer.state_dict(),
                        "step": self.step}, self._ckpt_path(tag))
            with open(os.path.join(self.workdir, "config.json"), "w") as f:
                f.write(self.cfg.to_json())
            with open(os.path.join(self.workdir, "history.json"), "w") as f:
                json.dump({"history": self.history,
                           "best_recall5": self.best_recall5}, f)
        if self.mesh is not None:
            torch.distributed.barrier(group=self.mesh)

    def load_checkpoint(self, tag: str) -> None:
        ckpt = torch.load(self._ckpt_path(tag), map_location=self.device)
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.step = int(ckpt["step"])
