"""gloc — the framework CLI, on the PyTorch port.

Port of ``gloc3d_tpu/cli.py``: one typed-config command covering every
mode of the reference's three entry points: main.py
(train/test/cluster/save_pt), the save_probability_img preprocessing
binary, and the global_localization evaluator.

  python -m gloc3d_tpu_torch.cli preprocess --scans DIR --out DIR [--fmt kitti]
  python -m gloc3d_tpu_torch.cli build-index --split SPLIT.npz --out DIR
  python -m gloc3d_tpu_torch.cli query --index DIR --scan FILE.bin
  python -m gloc3d_tpu_torch.cli serve --index DIR     (scan paths on stdin)
  python -m gloc3d_tpu_torch.cli export --out MODEL.pt2
  python -m gloc3d_tpu_torch.cli match-submap --grid GRID.npz --scan FILE
  python -m gloc3d_tpu_torch.cli cluster|train|eval --split SPLIT.npz ...
  python -m gloc3d_tpu_torch.cli gen-split --root KITTI_ROOT --which train|val
  python -m gloc3d_tpu_torch.cli stats --images DIR    (dataset mean/std)

Flags, names, defaults and the JSON on stdout are the JAX package's. All
subcommands accept --config CONFIG.json (a PipelineConfig dump, of either
package) and persist the effective config next to their outputs (the
flags.json round-trip, main.py:431-450). Subcommands that touch a device
take --device (default: the card; without one they exit with an error
unless given --device cpu). --checkpoint reads a JAX path-encoded or
VGGVLAD .npz, a reference .pth.tar or the port trainer's ckpt_*.pt; the
port reads no orbax directory (``tools/orbax_to_npz.py`` converts the JAX
trainer's into a path-encoded .npz). Weights not read from a checkpoint come
from the port's seeded init (``init_params``), not from JAX's
PRNGKey(0). ``build-index --dp-devices N`` spawns N ranks of one process
group (``parallel/launch.py``: NCCL with a card each, gloo where ranks
share a card or with --device cpu) that extract data-parallel; rank 0
writes the index.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def _load_cfg(args):
    from gloc3d_tpu_torch.config import PipelineConfig

    # index-consuming commands (query/serve) default to the config the
    # index was BUILT with (save() persists it) — serving a bank with a
    # mismatched model/config returns silently wrong candidates.
    idx_cfg = (os.path.join(args.index, "config.json")
               if getattr(args, "index", None) else None)
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())
    elif idx_cfg and os.path.exists(idx_cfg):
        with open(idx_cfg) as f:
            cfg = PipelineConfig.from_json(f.read())
    elif getattr(args, "i2i", False) or getattr(args, "encoder", None) not in (
            None, "pointpillar"):
        # --encoder picks the image backbone (main.py --arch, :519-564);
        # plain --i2i defaults to the published vgg16 configuration.
        cfg = PipelineConfig.i2i(getattr(args, "encoder", None) or "vgg16")
    else:
        cfg = PipelineConfig.s2s()
    if getattr(args, "quantize", None) not in (None, "none"):
        cfg = cfg.replace(index=cfg.index.replace(quantize=args.quantize))
    if getattr(args, "backend", None) not in (None, "flat"):
        cfg = cfg.replace(index=cfg.index.replace(backend=args.backend))
    if getattr(args, "optim", None):
        cfg = cfg.replace(train=cfg.train.replace(optimizer=args.optim))
    if getattr(args, "fast_match", None):
        # serving-matcher preset (RESULTS.md round 3): 'fm' adds the
        # Fourier-Mellin coarse estimator on top of the fine/prune levers
        cfg = cfg.fast_match(fm=args.fast_match == "fm")
    return cfg


def _save_cfg(cfg, outdir):
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "config.json"), "w") as f:
        f.write(cfg.to_json())


def _scan_files(d, exts=(".bin",)):
    return sorted(
        os.path.join(d, f) for f in os.listdir(d)
        if any(f.endswith(e) for e in exts)
    )


def _device(args):
    """The device a subcommand runs on: --device, else the card. Without a
    card and without --device the command exits with resolve_device's
    message: there is no quiet CPU run."""
    from gloc3d_tpu_torch.core.device import resolve_device

    try:
        return resolve_device(getattr(args, "device", None),
                              f"gloc {args.cmd}")
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")


def cmd_preprocess(args):
    """Scans → BEV probability images (save_probability_img.cpp equivalent),
    batched through the port's batch_scan_to_bev on the device."""
    import torch

    from gloc3d_tpu_torch.data.native import load_scan_batch, masks_from_counts
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev

    dev = _device(args)
    cfg = _load_cfg(args)
    files = _scan_files(args.scans)
    os.makedirs(args.out, exist_ok=True)
    _save_cfg(cfg, args.out)
    b = args.batch
    for i in range(0, len(files), b):
        chunk = files[i : i + b]
        pts, counts = load_scan_batch(chunk, args.fmt, cfg.bev.max_points)
        masks = masks_from_counts(counts, cfg.bev.max_points)
        with torch.no_grad():
            out = batch_scan_to_bev(
                torch.from_numpy(np.ascontiguousarray(pts[..., :3])).to(dev),
                torch.from_numpy(masks).to(dev), cfg.bev)
        imgs = (out.image * 255.0).cpu().numpy().astype(np.uint8)
        origins = out.origin_xy.cpu().numpy()
        for j, path in enumerate(chunk):
            stem = os.path.splitext(os.path.basename(path))[0]
            np.savez(
                os.path.join(args.out, stem + ".npz"),
                image=imgs[j], origin_xy=origins[j],
                resolution=cfg.bev.resolution,
            )
        print(f"[{i+len(chunk)}/{len(files)}] preprocessed", flush=True)
    return 0


def cmd_stats(args):
    """Channel mean/std over preprocessed images (get_data_stats.py)."""
    if not os.path.isdir(args.images):
        print(f"error: no such directory: {args.images}", file=sys.stderr)
        return 1
    files = _scan_files(args.images, exts=(".npz",))
    if not files:
        print(f"error: no .npz images found in {args.images}", file=sys.stderr)
        return 1
    s = ss = n = 0.0
    for f in files:
        img = np.load(f)["image"].astype(np.float64) / 255.0
        s += img.sum()
        ss += (img * img).sum()
        n += img.size
    mean = s / n
    std = float(np.sqrt(ss / n - mean * mean))
    print(json.dumps({"mean": mean, "std": std, "files": len(files)}))
    return 0


def cmd_gen_split(args):
    if args.dataset == "kitti":
        from gloc3d_tpu_torch.data.kitti import generate_split

        split = generate_split(args.root, args.which, args.skip_frames,
                               args.query_fraction, args.seed)
    elif args.dataset == "nclt":
        from gloc3d_tpu_torch.data.nclt import generate_split

        split = generate_split(args.root, args.which, args.skip_frames,
                               args.query_fraction, args.seed,
                               session=args.session)
    else:  # nuscenes: root is the manifest npz (see data/nuscenes.py)
        from gloc3d_tpu_torch.data.nuscenes import generate_split

        split = generate_split(args.root, args.skip_frames,
                               args.query_fraction, args.seed)
    split.save(args.out)
    print(f"wrote {args.out}: {len(split.db_files)} db, "
          f"{len(split.q_files)} queries")
    if args.valset_txt:
        from gloc3d_tpu_torch.data.valset import write_valset

        idx_path = args.valset_txt + "_index.txt"
        pose_path = args.valset_txt + "_pose.txt"
        write_valset(split, idx_path, pose_path, band=args.band,
                     max_pairs=args.valset_max_pairs, seed=args.seed)
        print(f"wrote valset artifact: {idx_path}, {pose_path} "
              f"(band={args.band}, max_pairs={args.valset_max_pairs})")
    return 0


def _seeded_model(cfg, seed=0):
    """The DescriptorModel of ``cfg`` with the port's seeded init."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params

    return init_params(build_model(cfg.model, cfg.voxel), seed)


def _restore_params(model, cfg, path):
    from gloc3d_tpu_torch.convert import restore_params

    if os.path.isdir(path):
        raise SystemExit(
            f"--checkpoint {path}: a directory (a JAX orbax checkpoint?); "
            f"the port reads no orbax directory. Convert it with `python "
            f"tools/orbax_to_npz.py {path} OUT.npz` (where JAX and orbax "
            f"run) and pass OUT.npz")
    return restore_params(model, path, cfg.model.encoder)


def _build_localizer(cfg, args, align_ground=False):
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    dev = _device(args)
    no_mirror = getattr(args, "no_host_mirror", False)
    kw = dict(align_ground=align_ground, device=dev,
              device_keyframes=(getattr(args, "device_keyframes", False)
                                or no_mirror),
              host_mirror=not no_mirror)
    blob_path = getattr(args, "from_export", None)
    if blob_path:
        # serve from a serialized torch.export program with NO
        # model-building code: the TorchScript→C++ hand-off equivalent
        # (main.py:189-198 → loop_detector.h:47-57). Weights live inside.
        from gloc3d_tpu_torch.export import ExportedDescriptorModel

        if getattr(args, "host_stats", False):
            raise SystemExit(
                "--from-export serves the plain forward; it cannot be "
                "combined with --host-stats (needs the real model)")
        with open(blob_path, "rb") as f:
            model = ExportedDescriptorModel(f.read(), dev)
        return GlobalLocalizer(cfg, model, None, **kw)
    model = _seeded_model(cfg)
    if args.checkpoint:
        _restore_params(model, cfg, args.checkpoint)
    return GlobalLocalizer(cfg, model, host_stats=getattr(args, "host_stats",
                                                          False), **kw)


def cmd_build_index(args):
    n = args.dp_devices
    if n == 1:
        _build_index(args)
    else:
        from gloc3d_tpu_torch.parallel.launch import check_ranks, spawn

        try:
            check_ranks(n)
        except ValueError as e:
            raise SystemExit(f"error: --dp-devices {n}: {e}")
        spawn(_build_index_rank, n, _device(args), args=(args,))
    print(f"index written to {args.out}")
    return 0


def _build_index_rank(rank, n, device, args):
    """One rank of ``build-index --dp-devices n`` (``parallel.launch``)."""
    import copy

    import torch.distributed as dist

    args = copy.copy(args)
    args.device = str(device)
    _build_index(args, dist.group.WORLD)


def _build_index(args, mesh=None):
    """Extract the split's db scans into a map and save it. Over a process
    group (``mesh``), as JAX's ``--dp-devices``: the extraction runs
    data-parallel, the batch is rounded up to a multiple of the ranks and
    the last chunk padded with empty scans, whose keyframes and bank rows
    are dropped; rank 0 prints and writes."""
    import torch.distributed as dist

    from gloc3d_tpu_torch.data.kitti import SplitIndex
    from gloc3d_tpu_torch.data.native import load_scan_batch, masks_from_counts

    cfg = _load_cfg(args)
    split = SplitIndex.load(args.split)
    loc = _build_localizer(cfg, args, align_ground=args.align_ground)
    b = args.batch
    say = print
    if mesh is not None:
        loc.shard_extraction(mesh)
        world = dist.get_world_size(mesh)
        b = -(-b // world) * world
        if dist.get_rank(mesh) != 0:
            say = lambda *a, **k: None  # noqa: E731
    files = split.db_files
    for i in range(0, len(files), b):
        chunk = files[i : i + b]
        pts, counts = load_scan_batch(chunk, args.fmt, cfg.voxel.max_points)
        masks = masks_from_counts(counts, cfg.voxel.max_points)
        if len(chunk) < b and mesh is not None:
            pad = b - len(chunk)
            pts = np.concatenate([pts, np.zeros((pad,) + pts.shape[1:],
                                                pts.dtype)])
            masks = np.concatenate([masks, np.zeros((pad,) + masks.shape[1:],
                                                    masks.dtype)])
        loc.add_keyframes(pts, masks)
        loc.keyframes = loc.keyframes[: i + len(chunk)]  # drop padded tail
        say(f"[{i+len(chunk)}/{len(files)}] indexed", flush=True)
    loc.bank.truncate(len(files))
    loc.save(args.out)


def _result_json(res) -> dict:
    out = {
        "success": bool(res.success),
        "db_index": int(res.db_index),
        "candidates": np.asarray(res.candidates).tolist(),
        "score": res.match_score,
    }
    if res.pose is not None:
        out["translation"] = np.asarray(res.pose.translation).tolist()
        out["rotation_wxyz"] = np.asarray(res.pose.rotation).tolist()
    return out


def _load_index(args):
    """(cfg, localizer with the index at args.index loaded), or None when
    there is no index there."""
    cfg = _load_cfg(args)
    if not os.path.exists(os.path.join(args.index, "bank.npz")):
        print(f"error: no index at {args.index} (missing bank.npz)",
              file=sys.stderr)
        return None
    loc = _build_localizer(cfg, args, align_ground=args.align_ground)
    loc.load(args.index)
    return cfg, loc


def cmd_serve(args):
    """Long-running localization server: scan paths on stdin (one per
    line), one JSON LocalizationResult per line on stdout. The production
    driver shape: load the index once, keep the model and the bank warm,
    stream queries through locate_fused when the device store is on, else
    locate()."""
    from gloc3d_tpu_torch.data.native import load_scan_batch, masks_from_counts
    from gloc3d_tpu_torch.models.encoders import is_image_encoder

    loaded = _load_index(args)
    if loaded is None:
        return 1
    cfg, loc = loaded
    i2i = is_image_encoder(cfg.model.encoder)
    use_fused = (loc.device_keyframes and not cfg.match.refine_icp
                 and cfg.index.backend != "sharded")
    print(json.dumps({"ready": True, "db_size": len(loc.bank),
                      "fused": use_fused, "i2i": i2i}), flush=True)
    for line in sys.stdin:
        path = line.strip()
        if not path:
            continue
        try:
            if i2i:
                # i2i index: the line names a BEV prob image (.npz or the
                # reference's .jpg/.png prob_img artifacts)
                from gloc3d_tpu_torch.data.images import load_bev_images

                imgs, origins = load_bev_images([path], cfg.bev.image_size)
                res = (loc.locate_fused(imgs[0], origin=origins[0])
                       if use_fused
                       else loc.locate(imgs[0], origin=origins[0]))
            else:
                pts, counts = load_scan_batch([path], args.fmt,
                                              cfg.voxel.max_points)
                masks = masks_from_counts(counts, cfg.voxel.max_points)
                res = (loc.locate_fused(pts[0], masks[0]) if use_fused
                       else loc.locate(pts[0], masks[0]))
            out = _result_json(res)
        except Exception as e:  # long-running server: NO per-scan error
            # (corrupt file, precondition RuntimeError, ...) may kill the
            # stream — it becomes a per-line error result instead
            out = {"success": False, "error": f"{type(e).__name__}: {e}"}
        out["scan"] = path
        print(json.dumps(out), flush=True)
    return 0


def cmd_query(args):
    from gloc3d_tpu_torch.data.native import load_scan_batch, masks_from_counts

    loaded = _load_index(args)
    if loaded is None:
        return 1
    cfg, loc = loaded
    pts, counts = load_scan_batch([args.scan], args.fmt, cfg.voxel.max_points)
    masks = masks_from_counts(counts, cfg.voxel.max_points)
    res = loc.locate(pts[0], masks[0])
    if getattr(args, "dump_match", None):
        _dump_match_overlay(loc, pts[0], masks[0], res, args.dump_match)
    print(json.dumps(_result_json(res)))
    return 0


def _read_bev_npz(path):
    """A preprocess-format .npz → (fp32 image in [0, 1], origin,
    resolution)."""
    g = np.load(path)
    img = g["image"].astype(np.float32)
    if img.max() > 1.5:  # preprocess writes uint8 0..255
        img = img / 255.0
    return img, np.asarray(g["origin_xy"], np.float32), float(g["resolution"])


def cmd_match_submap(args):
    """Full-submap matching at the CLI surface: place a query scan in a
    submap BEV grid with the certificate→fallback matcher policy
    (the TestGridMatch / MatchFullSubmap evaluator role,
    global_registration.cpp:778-840, fast_correlative_scan_matcher_2d.cpp:
    248-268). Query = a raw scan (.bin) or a preprocessed BEV (.npz); the
    submap grid = a preprocess-format .npz (image, origin_xy, resolution).
    """
    import math

    import torch

    from gloc3d_tpu_torch.ops.occupancy import ProbabilityGrid2D
    from gloc3d_tpu_torch.ops.refine import bev_to_virtual_points
    from gloc3d_tpu_torch.ops.scan_match import match_full_submap

    dev = _device(args)
    cfg = _load_cfg(args)
    img, origin, res_m = _read_bev_npz(args.grid)
    grid = ProbabilityGrid2D.from_bev_image(
        torch.from_numpy(img).to(dev), origin, res_m)

    if args.scan.endswith(".npz"):
        q_img, q_org, q_res = _read_bev_npz(args.scan)
        q_img = torch.from_numpy(q_img).to(dev)
        q_org = torch.from_numpy(q_org).to(dev)
    else:
        from gloc3d_tpu_torch.data.native import (
            load_scan_batch, masks_from_counts)
        from gloc3d_tpu_torch.ops.bev import scan_to_bev

        pts, counts = load_scan_batch([args.scan], args.fmt,
                                      cfg.bev.max_points)
        masks = masks_from_counts(counts, cfg.bev.max_points)
        bev = scan_to_bev(
            torch.from_numpy(np.ascontiguousarray(pts[0, :, :3])).to(dev),
            torch.from_numpy(masks[0]).to(dev), cfg.bev)
        q_img, q_org, q_res = bev.image, bev.origin_xy, cfg.bev.resolution
    # query BEV → virtual scan in the query's own frame (the grid→cloud
    # trick, fast_correlative_scan_matcher_2d.cpp:78-95)
    pts_xy, valid = bev_to_virtual_points(q_img, q_org, q_res, args.budget)
    r = match_full_submap(
        grid, pts_xy, valid,
        num_rotations=args.rotations, max_scan_range=args.max_range,
        fallback=args.fallback)
    pose = r.pose.double().cpu().numpy()
    print(json.dumps({
        "pose_xy_yaw": [round(float(pose[0]), 4), round(float(pose[1]), 4),
                        round(float(pose[2]), 6)],
        "yaw_deg": round(math.degrees(float(pose[2])), 3),
        "score": round(float(r.score), 5),
        "certified": bool(r.certified),
        "used_fallback": bool(r.used_fallback),
        "fallback_policy": args.fallback,
    }))
    return 0


def _dump_match_overlay(loc, points, mask, res, out_path):
    """Registration-overlay debug artifact (`query --dump-match`): query BEV
    warped by the recovered (dx, dy, yaw) onto the matched db BEV. On match
    failure the overlay uses the identity transform against the top-1
    candidate — the raw misalignment is still the useful debug picture."""
    from gloc3d_tpu_torch.data.viz import match_overlay, save_png

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    cand = res.db_index if res.success else (
        int(res.candidates[0]) if len(res.candidates) else -1)
    if cand < 0 or cand >= len(loc.keyframes):
        print(f"note: no candidate to overlay; skipping {out_path}",
              file=sys.stderr)
        return
    kf = loc.keyframes[cand]
    if kf.image is None:
        print("note: keyframes have no host-side images "
              f"(host_mirror=False index); skipping {out_path}",
              file=sys.stderr)
        return
    _, _, bev, _ = loc.detect(points[None],
                              mask[None] if mask is not None else None)
    xy_yaw = (np.asarray(res.match_xy_yaw, np.float64)
              if res.success else np.zeros(3))
    ov = match_overlay(
        host(bev.image[0]), host(bev.origin_xy[0]),
        kf.image, np.asarray(kf.origin_xy), xy_yaw,
        float(np.asarray(bev.resolution)))
    if save_png(out_path, ov):
        state = "registered" if res.success else "FAILED match, identity"
        print(f"wrote {out_path} ({state}, db keyframe {cand})",
              file=sys.stderr)


def _example_inputs(cfg, dev):
    """Zero inputs at the serving shape (B=1) on ``dev``."""
    import torch

    if cfg.model.encoder == "pointpillar":
        n = cfg.voxel.max_points
        return (torch.zeros((1, n, 4), device=dev),
                torch.zeros((1, n), device=dev))
    s = cfg.bev.image_size
    return (torch.zeros((1, s, s, 3), device=dev),)


def cmd_export(args):
    """Export the descriptor model with torch.export (main.py --mode=save_pt
    parity); the program carries the gloc3d:: kernel ops."""
    from gloc3d_tpu_torch.export import export_descriptor_model

    dev = _device(args)
    cfg = _load_cfg(args)
    model = _seeded_model(cfg)
    if args.checkpoint:
        _restore_params(model, cfg, args.checkpoint)
    if getattr(args, "fold_bn", False) and cfg.model.encoder == "pointpillar":
        from gloc3d_tpu_torch.convert import fold_batch_norm
        from gloc3d_tpu_torch.models.descriptor import build_model

        folded = build_model(cfg.model.replace(fold_bn=True), cfg.voxel)
        folded.load_state_dict(fold_batch_norm(model.state_dict()))
        model = folded
    blob = export_descriptor_model(model.to(dev), *_example_inputs(cfg, dev))
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob)} bytes, torch.export)")
    return 0


def _load_split_dataset(cfg, split, args):
    """s2s: decode raw scans; i2i: load preprocessed BEV images (--images)."""
    from gloc3d_tpu_torch.models.encoders import is_image_encoder

    if is_image_encoder(cfg.model.encoder):
        if not getattr(args, "images", None):
            raise SystemExit(
                f"i2i ({cfg.model.encoder}) train/eval needs --images DIR of "
                "preprocessed BEV npz files (see `preprocess`)")
        from gloc3d_tpu_torch.data.images import load_split_images

        return load_split_images(split, args.images, cfg.bev.image_size)
    from gloc3d_tpu_torch.data.kitti import load_split_scans

    return load_split_scans(split, cfg.voxel.max_points)


def cmd_cluster(args):
    """VLAD centroid initialization (main.py --mode=cluster): sample encoder
    descriptors over the db set, k-means them, save centroids + samples
    (the desc_cen.hdf5 equivalent) for train --init-centroids."""
    import torch

    from gloc3d_tpu_torch.data.kitti import SplitIndex
    from gloc3d_tpu_torch.train.cluster import init_vlad_from_data

    dev = _device(args)
    cfg = _load_cfg(args)
    split = SplitIndex.load(args.split)
    ds = _load_split_dataset(cfg, split, args)
    model = _seeded_model(cfg).to(dev)
    cents, descs = init_vlad_from_data(
        cfg, model, ds.db_inputs, ds.db_masks,
        torch.Generator().manual_seed(cfg.train.seed),
        num_images=args.num_images, per_image=args.per_image,
    )
    cents, descs = cents.cpu().numpy(), descs.cpu().numpy()
    np.savez(args.out, centroids=cents, descriptors=descs)
    print(f"wrote {args.out}: centroids {cents.shape}, "
          f"descriptors {descs.shape}")
    return 0


def cmd_train(args):
    from gloc3d_tpu_torch.data.kitti import SplitIndex
    from gloc3d_tpu_torch.models.encoders import train_mask
    from gloc3d_tpu_torch.train.trainer import Trainer

    dev = _device(args)
    cfg = _load_cfg(args)
    if getattr(args, "host_stats", False):
        # s2s fast path: host pillar stats + counting sort feed the
        # K1 train step (TrainConfig.host_stats)
        cfg = cfg.replace(train=cfg.train.replace(host_stats=True))
    split = SplitIndex.load(args.split)
    ds = _load_split_dataset(cfg, split, args)
    model = _seeded_model(cfg, cfg.train.seed)
    if args.init_centroids:
        from gloc3d_tpu_torch.models.netvlad import init_netvlad_params

        cc = np.load(args.init_centroids)
        init_netvlad_params(model.pool, cc["centroids"], cc["descriptors"],
                            vladv2=cfg.model.vladv2)
    # main.py:531-541: pretrained image encoders train only their top
    # block; --fromscratch lifts the freeze (reference --fromscratch)
    tmask = train_mask(model, cfg.model.encoder, args.fromscratch)
    trainer = Trainer(cfg, model, ds, args.workdir, trainable_mask=tmask,
                      device=dev)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    trainer.fit()
    print(json.dumps({"best_recall5": trainer.best_recall5,
                      "epochs": len(trainer.history)}))
    return 0


def cmd_eval(args):
    from gloc3d_tpu_torch.data.kitti import SplitIndex

    dev = _device(args)
    cfg = _load_cfg(args)
    split = SplitIndex.load(args.split)
    ds = _load_split_dataset(cfg, split, args)
    model = _seeded_model(cfg)
    if args.checkpoint:
        _restore_params(model, cfg, args.checkpoint)

    if args.registration:
        # full GlocEvaluator flow: recognition + registration + failures
        from gloc3d_tpu_torch.eval.evaluator import evaluate_split
        from gloc3d_tpu_torch.pipeline import GlobalLocalizer

        loc = GlobalLocalizer(cfg, model, align_ground=args.align_ground,
                              host_stats=args.host_stats, device=dev)
        report = evaluate_split(loc, ds, out_dir=args.workdir,
                                batch=args.batch)
        print(report.to_json())
        return 0

    from gloc3d_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, model, ds, args.workdir or tmp, device=dev)
        rec = trainer.evaluate(ds)
    print(json.dumps({"recall": {str(k): v for k, v in rec.items()}}))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="gloc", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="torch device to run on (default: the card; "
                             "--device cpu runs on the CPU)")

    def common(sp, fmt=True):
        sp.add_argument("--config", default=None)
        sp.add_argument("--i2i", action="store_true")
        sp.add_argument(
            "--encoder", default=None,
            choices=("vgg16", "alexnet", "mobilenet", "resnet18",
                     "pointpillar"),
            help="backbone (main.py --arch choices + the s2s pointpillar)")
        sp.add_argument("--checkpoint", default=None,
                        help="weights: a JAX path-encoded or VGGVLAD .npz, "
                             "a reference .pth.tar or the port trainer's "
                             "ckpt_*.pt (no orbax directory: "
                             "tools/orbax_to_npz.py converts one)")
        sp.add_argument("--batch", type=int, default=8)
        sp.add_argument("--quantize", default=None, choices=("none", "int8"),
                        help="descriptor-bank storage: int8 stores per-row "
                             "symmetric codes + exact norms (4x less device "
                             "memory at map scale; beyond-reference mode)")
        sp.add_argument("--backend", default=None, choices=("flat", "ivf"),
                        help="index backend: flat exact bank or IVF "
                             "partitioned cells (map scale; composes "
                             "with --quantize int8)")
        sp.add_argument("--fast-match", default=None, dest="fast_match",
                        choices=("preset", "fm"),
                        help="serving-matcher preset (÷2 two-stage fine + "
                             "pooled θ-argmax + top-4 pruning); 'fm' adds "
                             "the Fourier-Mellin coarse estimator — "
                             "defaults stay exact-parity")
        sp.add_argument("--host-stats", action="store_true",
                        help="pointpillar fast path: pillar stats/sort on "
                             "the host during IO (kernel K1 on the sorted "
                             "rows); for train this feeds the host-stats "
                             "step")
        sp.add_argument("--device-keyframes", action="store_true",
                        help="bit-packed device keyframe store (72 KB/frame "
                             "at 768²; match gathers candidates by index)")
        sp.add_argument("--no-host-mirror", action="store_true",
                        help="map-scale ingest: keep keyframe images ONLY "
                             "in the device store (implies "
                             "--device-keyframes; no host RAM copy)")
        device(sp)
        if fmt:
            sp.add_argument("--fmt", default="kitti",
                            choices=("kitti", "nuscenes", "nclt"))

    sp = sub.add_parser("preprocess", help="scans → BEV images")
    sp.add_argument("--scans", required=True)
    sp.add_argument("--out", required=True)
    common(sp)
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("stats", help="image mean/std")
    sp.add_argument("--images", required=True)
    sp.set_defaults(fn=cmd_stats)

    sp = sub.add_parser("gen-split", help="build train/val split index")
    sp.add_argument("--root", required=True,
                    help="dataset root (kitti/nclt) or manifest npz (nuscenes)")
    sp.add_argument("--dataset", default="kitti",
                    choices=("kitti", "nclt", "nuscenes"))
    sp.add_argument("--session", default=None, help="NCLT session override")
    sp.add_argument("--which", default="train", choices=("train", "val"))
    sp.add_argument("--skip-frames", type=int, default=5)
    sp.add_argument("--query-fraction", type=float, default=0.2)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", required=True)
    sp.add_argument("--valset-txt", default=None,
                    help="also export the two-file text valset artifact "
                         "(reference write_valset_to_txt format) with this "
                         "path prefix")
    sp.add_argument("--valset-max-pairs", type=int, default=None,
                    help="cap exported (query, db) pairs by random sampling "
                         "(nuScenes exporter's <=100, nuscenes_s2s.py:295)")
    sp.add_argument("--band", default="easy",
                    choices=("easy", "medium", "hard"))
    sp.set_defaults(fn=cmd_gen_split)

    sp = sub.add_parser("build-index", help="extract db descriptors + grids")
    sp.add_argument("--split", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--align-ground", action="store_true")
    sp.add_argument("--dp-devices", type=int, default=1,
                    help="data-parallel extraction over this many ranks, "
                         "spawned by the command (NCCL with a card each, "
                         "gloo where they share a card or on --device cpu; "
                         "at most one per CPU core)")
    common(sp)
    sp.set_defaults(fn=cmd_build_index)

    sp = sub.add_parser("query", help="localize one scan against an index")
    sp.add_argument("--index", required=True)
    sp.add_argument("--scan", required=True)
    sp.add_argument("--align-ground", action="store_true")
    sp.add_argument("--from-export", metavar="BLOB",
                    help="extract the query descriptor with a serialized "
                         "torch.export program (`gloc export`) instead of "
                         "building the model — the TorchScript hand-off "
                         "equivalent; no model code or checkpoint needed")
    sp.add_argument("--dump-match", metavar="PNG",
                    help="write a registration-overlay debug image: the "
                         "query BEV warped by the recovered (dx, dy, yaw) "
                         "onto the matched db BEV (i2i_util.py:540-620 / "
                         "loop_detector.cpp:224-232 equivalent)")
    common(sp)
    sp.set_defaults(fn=cmd_query)

    sp = sub.add_parser(
        "serve", help="stream localization: scan paths on stdin → JSON "
                      "results on stdout (load index once, stay warm)")
    sp.add_argument("--index", required=True)
    sp.add_argument("--align-ground", action="store_true")
    common(sp)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "match-submap",
        help="place a scan in a submap grid (full 360° certified matcher)")
    sp.add_argument("--grid", required=True,
                    help="submap BEV .npz (image, origin_xy, resolution)")
    sp.add_argument("--scan", required=True,
                    help="query: raw scan (.bin/.fmt) or BEV .npz")
    sp.add_argument("--fmt", default="kitti")
    sp.add_argument("--config")
    sp.add_argument("--rotations", type=int, default=None,
                    help="rotation count (default: the Olson sub-cell "
                    "bound at --max-range)")
    sp.add_argument("--max-range", type=float, default=50.0)
    sp.add_argument("--fallback", default="full",
                    choices=["full", "theta", "none"])
    sp.add_argument("--budget", type=int, default=4096,
                    help="virtual-scan point budget")
    device(sp)
    sp.set_defaults(fn=cmd_match_submap)

    sp = sub.add_parser("export", help="export the descriptor model")
    sp.add_argument("--out", required=True)
    sp.add_argument("--fold-bn", action="store_true",
                    help="fold BatchNorm into conv weights before export "
                         "(serving; pointpillar only)")
    common(sp, fmt=False)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("cluster", help="VLAD centroid init (k-means)")
    sp.add_argument("--split", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--images", default=None)
    sp.add_argument("--num-images", type=int, default=500)
    sp.add_argument("--per-image", type=int, default=100)
    common(sp, fmt=False)
    sp.set_defaults(fn=cmd_cluster)

    sp = sub.add_parser("train", help="triplet training")
    sp.add_argument("--split", required=True)
    sp.add_argument("--workdir", required=True)
    sp.add_argument("--optim", default=None, choices=("sgd", "adam"),
                    help="optimizer (main.py --optim: ADAM is plain "
                         "Adam(lr), SGD gets momentum+wd+StepLR)")
    sp.add_argument("--fromscratch", action="store_true",
                    help="train the whole image encoder (default freezes "
                         "below the top block, main.py:531-541)")
    sp.add_argument("--init-centroids", default=None,
                    help="centroids npz from the cluster subcommand")
    sp.add_argument("--images", default=None,
                    help="preprocessed BEV npz dir (required for i2i)")
    sp.add_argument("--resume", default=None,
                    help="checkpoint tag in --workdir (ckpt_<tag>.pt)")
    common(sp, fmt=False)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval", help="recall@N / full localization evaluation")
    sp.add_argument("--split", required=True)
    sp.add_argument("--workdir", default=None)
    sp.add_argument("--images", default=None,
                    help="preprocessed BEV npz dir (required for i2i)")
    sp.add_argument("--registration", action="store_true",
                    help="full end-to-end eval incl. registration "
                         "(global_localization binary parity)")
    sp.add_argument("--align-ground", action="store_true")
    common(sp, fmt=False)
    sp.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
