#!/usr/bin/env python3
"""Drive the PyTorch port's s2s and i2i located queries (the all-device
s2s extraction both by K2 and by the device pillar sort), the refinement
stage, the SLAM submap, s2s, i2i and pose training, the packed and
pillar-sorted PointPillar, the evaluator over a dataset read from disk, the
command line, and the multi-rank paths (the sharded search and keyframe
store, the sharded matcher, data parallelism, the i2i spatial partition)
once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (torch's name, and nvidia-smi's name and power limit);
  2. build kernels K1 (csrc/segment_sum.cu), K2 (csrc/pillar_bin_sums.cu)
     and the ground estimate's k-NN normals (csrc/knn_normals.cu) from the
     checkout, one nvcc each, started together, and the port's host
     pass (gloc3d_tpu_torch/native/scan_loader.cpp, g++); any build failure
     fails the smoke;
  3. K1 against its plain PyTorch version on the card: the main-path shape
     with real `starts` from the host pass, pillar 0 holding > 50k rows,
     empty segments, every row in one segment (segment 0, a middle one),
     batch 3 with different `starts` per item, and C in {2, 4, 62, 66,
     256} (C=4: PointPillarSorted's statistics payload);
     error relative to per-segment L1 mass (bound 1e-5), empty segments
     exactly 0; CUDA-event times of both at the main-path shape; pillar 0
     bit-equal over four launches on the main-path input;
  4. K2 against its plain version on the card, on the inputs the
     all-device path gives it for a real scan before and after alignment
     ((1, 122480, 4) pillar statistics with counts, (1, 122480, 64) PointNet
     features), pillar 0 holding > 80k rows, every row in pillar 0, empty
     pillars, C in {1, 3, 4, 65, 256} on the scan's ids and features at a
     4-byte offset, 50 000 rows in one pillar other than 0, every row in
     pillar 7, ids in descending order, the main-path scan with its rows
     permuted; error relative to per-pillar L1 mass (bound 1e-5), counts
     exactly equal, empty pillars exactly 0, the kernel's status clean, and
     every pillar and the counts bit-equal over four launches, in every
     case; item 3 of a batch of 24 bit-equal to the same item binned alone;
     three planted out-of-range ids raise ValueError naming the kernel's
     reading and the host's; CUDA-event times of both;
  5. the located query on the host-stats path at full PipelineConfig.s2s()
     width (122 480-point scans, 768² BEV, top-20, 120 coarse / 11 fine
     rotations) with the folded bf16 serving model from the port's seeded
     init (NetVLAD clusters initialised from local features, see
     vlad_centroids): 16 keyframes and 8 `locate` queries in a synthetic
     walled world;
     every query must succeed within 1 m and 5° of the ground-truth pose
     relative to the keyframe it returns, K1 must have launched on that
     path, and one query is checked against the same code on the CPU;
  6. the gravity-aligned located query on the all-device path
     (align_ground=True, host_stats=False; 4096-candidate, 256-hypothesis
     ground RANSAC): 16 keyframes on a 0.75 m grid and 8 queries, scans
     tilted by up to 3° in roll and pitch at sensor heights of 1.6-1.9 m
     (the layout is explained at aligned_world_scans); every query must
     localize within 1 m / 5° of the 6-DoF ground truth with |dz| < 0.3 m,
     every keyframe height must come back within 0.15 m, and K2 must have
     launched twice per keyframe batch and per query;
  7. the same queries with align_ground=True, host_stats=True against
     host_stats=False, both with the fp32 model: same keyframe, pose within
     0.2 m / 0.5°, K1 launched;
  8. one aligned query on the card against the same port code on the CPU
     (fp32, TF32 off, the same draws): same ground transform, equal BEV,
     descriptors within atol 2e-4 + rtol 2e-3, same keyframe;
  9. the serving path, fast_match(fm=True) with the device keyframe store
     and no host mirror: locate_fused on the host-stats map of phase 5
     (K1 launches counted) and on the aligned map of phase 6 (K2 launches
     counted), every query held to that phase's gates (a failing query's
     BEVs go to smoke_out/); locate = locate_batch = locate_fused on the
     fp32 host-stats map (success, keyframe, candidates equal, (dx, dy,
     yaw) within 1e-4) and locate = locate_fused on the aligned map with
     the same draws; bench.py's fused cells (10 000-row bank with the
     real descriptor at row 5 000, a 10 000-row store, bf16, fold_bn),
     host stats and aligned all-device: row 5 000 found, per-query host
     clock of locate_fused and locate, host syncs per call, a traced
     locate_fused's device busy time, and registration at K=1 and K=20
     with the fm preset and the default matcher (CUDA events and device
     busy time); one fm-preset locate_fused query card vs CPU (fp32, same
     keyframe, (dx, dy) within one 0.4 m fine cell, yaw within one bin);
 10. [map-scale], tools/bench_bank.py's settings: 1 000 000 unit-norm rows
     at D = 128 and 512, top-20, a planted near-duplicate of row 123, on
     the flat fp32 and int8 banks and the IVF index with fp32 and int8
     cells (1024 cells of 2048 rows, nprobe 32, the quantizer trained on
     65 536 rows): build times, device bytes, per-query times at Q = 1 and
     8 split into the distance pass and the selection beside the bound
     (bytes read / 3.35 TB/s), the two int8 products and torch.topk beside
     the stable sort; the planted row at rank 1, int8 rank 1 = fp32 rank 1,
     IVF at full probe = flat, exclude_after, one IVF query card = CPU on
     one loaded layout, int8 and IVF save / load on the card;
 11. [city], tools/bench_city.py's map: 100 000 keyframes on the IVF +
     int8 bank (1024 cells, nprobe 32) with the device store and no host
     mirror, host stats, the fm preset, bench.py's scan planted at row
     50 000: locate_fused returns and registers it; per-query time beside
     the 10 000-row flat fused cell's, device bytes, build time;
 12. timings with the card's name and power limit: detect at bench.py's
     shape and the located query, host-stats and all-device (the default); the aligned detect and locate,
     the aligned stage split, and the device's idle share over one aligned
     query from a torch.profiler trace;
 13. the i2i path at PipelineConfig.i2i() (VGG16 + NetVLAD-FC, 64 clusters x
     512, FC 32 768 → 512, bf16, 768² BEV; seeded weights, NetVLAD
     initialised from the VGG feature maps of the aligned map's db BEVs):
     a. bench.py's i2i cell: detect (forward + top-20 over a random
        10 000 x 512 bank) per query at B=1 and B=8 (CUDA events), the
        forward's FLOPs from its conv shapes, achieved TFLOP/s and
        i2i_forward_mfu against 989 TFLOP/s dense bf16, a traced detect's
        device busy time, kernel count and device time by class;
     b. the paper's configuration, align_ground=True on the tilted map of
        phase 6 (16 keyframes, 8 queries) held to its gates, per-query
        time, its stages and the idle share;
     c. image inputs on the serving configuration (fast_match(fm=True),
        device store, no host mirror): the located world's BEVs rendered
        by the port as (B, S, S, 3) images with origins, image queries
        held to phase 5's gates; locate = locate_fused (bf16) and locate
        = locate_batch = locate_fused (fp32: same db_index and candidate
        set, (dx, dy, yaw) within 1e-4); per-query time, host syncs;
     d. card vs CPU, fp32 with TF32 off in cuDNN and matmul: one 768²
        forward (relative L2 error of the descriptor, limit 1e-3) and one
        aligned i2i located query (same keyframe, pose within 1e-3 m);
 14. training at full width on each path, all-device then host-stats (24 db
     + 8 query scans, init_vlad_from_data, the default step of 24 clouds):
     one epoch with K1 / K2 launch and backward counts, a finite loss, a
     nonzero gradient for every encoder parameter and changed parameters;
     every kernel launch of one cache batch and one step held to its plain
     version; step and cache-refresh times, peak memory, a traced step;
 15. both kernels' autograd Functions against autograd through the plain
     versions at (24, 122480, 64): forward (bound 1e-5 of L1 mass), gradient
     (bound 1e-6), backward times;
 16. one fp32 step on each path, card against CPU at a 16 384-point pad:
     loss within rtol 1e-4, gradients within twice the CPU's own floor
     (mkldnn convolutions off against on);
 17. each kernel alone at the main path's and the train step's shapes: its
     device time from torch.profiler (L2-warm and L2-flushed), its bound,
     the wrapper's time (K2's with and without its read of the kernel's
     status, and the read alone), the plain version's, and the time of the
     one PyTorch
     call computing the same function (K1: torch.segment_reduce; K2:
     index_add_ + bincount).
 18. [refine], after the i2i phases: (a) the ICP polish
     (match.refine_icp, 4096-point clouds, 10 iterations, 1 m gate) at
     full width with the fp32 serving model on the host-stats located map
     (16 keyframes, 8 queries: the located gates, the mean position error
     at most the unrefined map's, locate = locate_batch, match_keyframe on
     the host mirror and on the device store = locate for the keyframe
     locate returns, K1 launches) and with the bf16 model on the aligned
     all-device map (6-DoF gates, mean 6-DoF position error at most the
     aligned phase's, K2 launches); one refined query card vs CPU and the
     ICP alone on the same clouds and seed; (b) the port's SLAM example
     (gloc3d_tpu_torch/examples/slam_session.py) at its default size: no
     closure on lap 1, lap 2 within 1 m / 5°; (c) tools/bench_refine.py's
     five rows at its shapes (icp_point_to_point 4096 vs 4096, 20
     iterations; refine_match_icp on two 768² BEVs; build_ndt_grid_3d
     into 100x100x12 at 1 m; ndt_refine_3d, 35 iterations;
     ergodic_rp_sweep_match, 49 BEVs at 768², fm preset) and
     contour_virtual_cloud on a 768² BEV: CUDA-event ms, a traced call's
     busy ms, idle share and kernels, host syncs per call, card vs CPU
     within stated bounds; the connected-components sweeps at 768².
 19. [submap], after [refine], at tools/bench_submap.py's shapes
     (BEVConfig(z_min=-4, z_max=4), ±100 m: the high grid 1000x1000x40 at
     0.2 m, the low 400x400x16 at 0.5 m): ten 122 480-pad sweeps of the
     walled world from (1.5 i, 0.4 i) m at yaw 0.06 i, i < 10; ms per
     dual-grid Submap3D.insert (a world sweep and bench.py's scan) and host
     syncs; project_to_bev of the 10-sweep high grid to 768²; one sweep's
     insert and projection card vs CPU, bit-equal; match_scan and
     match_scan_fast on the 512² centre crop with sweep 0's 4096-point
     virtual scan at R = 64, 256 and the local R = 32 ±0.15 rad (a
     certified fast result must be the exhaustive optimum), match_scan at
     R = 64 card vs CPU (the same optimum); fast against exhaustive at the
     Olson-bound R on bench_submap.py's offset query (4.0, -2.0, 0.35 rad,
     σ 0.10 m); match_full_submap(fallback="full") and cmd_match_submap's
     composition (scan_to_bev → bev_to_virtual_points →
     match_full_submap) recovering that offset within one cell and one
     angular step; cuFFT against float64 direct sums (fine and coarse
     FFT) below the certificate's 0.05-count slack.
 20. [i2i-train], after training: PipelineConfig.i2i() (VGG16 +
     NetVLAD-FC, bf16) at 768² on the training world's BEVs rendered by the
     port (24 db, 8 queries; margin 10 so that every batch takes a step),
     NetVLAD from init_vlad_from_data, the reference's freeze mask
     (models/encoders.py::train_mask): one epoch (the loss finite, every
     trainable parameter with a nonzero gradient and moved, every frozen
     one bit-unchanged), two timing epochs (median warm step, cache refresh
     per image, peak memory, the step's conv FLOPs against 989 TFLOP/s);
     one fp32 step card vs CPU at a 128² crop (loss rtol 1e-4, gradients
     within twice the CPU's mkldnn-on-vs-off floor); one step each of
     AlexNet, MobileNetV2 and ResNet18 under their masks;
 21. [pose-train]: make_pose_model(PipelineConfig.s2s()) at the 140 x 80
     grid, 4 walled-world scan pairs at the 122 480 pad with their
     relative pose as gt, Adam 1e-3, 25 steps on the fixed batch: JAX's
     criterion (min < 0.7 x the largest of the first three losses), K2
     launches and backward calls counted, every K2 launch of one step
     against its plain version, one fp32 step card vs CPU at a 16 384-point
     pad, predict_pose (4, 6) and finite; step ms, peak memory;
 22. [packed]: one full-pad scan through PointPillar (K2),
     PointPillarPacked (pack_points, K2) and PointPillarSorted (the host
     pass, K1 on the 4-channel payload and the 64-channel features) from
     one fp32 state dict: pillar means within 1e-5 and outputs within 1e-4
     of PointPillar's largest; forward times, launches.
 23. [eval], after [submap]: one KITTI odometry sequence written into a
     temporary directory (sequences/08/velodyne/NNNNNN.bin, poses/08.txt,
     calib.txt): 50 walled-world scans at the 122 480-point pad, 2 m
     apart with yaw changes, cam0 poses written through a non-identity Tr;
     generate_split (40 db, 10 queries) and load_split_scans through the
     port's native loader, the scans bit-equal to the written ones and the
     velodyne poses within 1e-5; one more query, 140 m from every frame;
     evaluate_split (batch 8, recall@{1, 5, 10, 20}) with the folded bf16
     model on the host-stats path (K1) and the aligned all-device path
     (K2): the full EvalReport, K1 / K2 launches, every launch of one
     evaluator batch against its plain version (bound 1e-5 of L1 mass),
     gates: (a) on the fp32 host-stats map the evaluator's per-query
     results = locate's query by query, (b) num_total = 11, success rate
     and recall@5 at least 2/3, mean position error below 1 m, (c) the far
     query a failed registration with its overlay rendered (a PNG only
     where matplotlib is installed), npz dumps exactly for the failed
     detections, the failed-index files written, (d) the CPU's fp32 run
     on the first 16 db and 4 queries = the card's (candidates,
     successes, failed indices; errors within 1e-3 m / 1e-3 rad); db
     build per scan, locate per query, p50 / p95 beside the card's name
     and power limit.
 24. [cli], after [eval]: every subcommand of gloc3d_tpu_torch/cli.py,
     in-process through cli.main (launches counted) unless said otherwise,
     on [eval]'s KITTI sequence (with an empty sequence 09, so that
     `gen-split --which val` reads 08 alone) at the 122 480-point pad,
     PipelineConfig.s2s() folded bf16, the smoke's seeded weights and
     NetVLAD centroids saved as a port checkpoint (ckpt.pt) that every
     subcommand loads with --checkpoint: (1) gen-split = [eval]'s split;
     (2) build-index with host stats and the device store (K1) and with
     --align-ground --device-keyframes --no-host-mirror (K2); (2b)
     build-index --dp-devices 2 (two gloo ranks spawned on the card, fp32,
     host stats) = --dp-devices 1 (keyframes equal, descriptors 1e-5);
     (3) query on each = locate in this process on the loaded map (db_index,
     candidates ranked, translation within 1e-4 m); (4) one query as a
     fresh `python -m gloc3d_tpu_torch.cli` process: its cold start split
     into process start to imports, localizer built, index load, first
     query; (5) serve over the 10 query paths and a missing file on the
     host-stats map (fused): each line = that scan's locate, the missing
     file an error line, warm ms per line; (6) export (fp32, --fold-bn)
     on the card and with --device cpu: each graph holds
     gloc3d::pillar_bin_sums and no index_add_ / bincount, K2 launches
     when the program runs on the card, and a fresh process that imports
     gloc3d_tpu_torch.kernels.ops alone reloads both onto the card with
     descriptors within 1e-5 of the live model's; (7) query
     --from-export = the live fp32 query (candidates ranked), and the
     exported forward and
     locate beside the live ones; (8) preprocess = batch_scan_to_bev bit
     for bit, and stats; (9) match-submap of scan 0's BEV in scan 1's
     grid within one 0.2 m cell and one of 512 angular steps of the
     truth; (10) cluster, then train --init-centroids --host-stats, one
     epoch (JSON keys, ckpt_*.pt, K1 launches); (11) eval --registration
     --host-stats = evaluate_split in this process; (12)
     profiling.trace around one locate names K1's kernel.
 25. [shard], after [city]: the sharded search (gloc3d_tpu_torch/parallel/,
     index/ivf.py::ShardedIVF, GlobalLocalizer.shard_bank). World size 1
     over NCCL in this process: sharded_topk, sharded_topk_int8 and
     ShardedBank (fp32, int8) at [map-scale]'s 1 000 000 rows, D = 512,
     Q = 8, k = 20, and ShardedIVF over [city]'s IVF + int8 index (100 000
     rows, 1024 cells, nprobe 32), each = its unsharded call (ids equal,
     distances bit-equal); shard_bank + locate on phase 5's host-stats map
     = its unsharded locate, ranked. World size 2 over gloo: two ranks
     spawned with torch.multiprocessing on the one card, 500 000 rows each,
     ids equal to the unsharded call's wherever neighbouring distances lie
     1e-5 apart. The sharded keyframe store (GlobalLocalizer.
     shard_keyframes) on phase 5's map with the device store (768²
     bitmaps, no host mirror) at world 1 and in both world-2 ranks:
     locate, locate_batch and locate_fused before and after sharding
     bit-equal, each rank's store bytes beside the unsharded store's, the
     saved map = the unsharded save, a keyframe added after sharding, the
     map loaded into a sharded localizer (world 1), the K1 launches of
     the sharded store's queries (2 · 8 + 1 on each rank, and one
     for each capture of locate_fused's program at world 1);
     match_scan_fast_sharded at the Olson count rounded up to a multiple
     of 2 (1 572) on a 512² grid cut from keyframe 0's BEV with
     bench_submap.py's offset query: world 1 = match_scan_fast bit for bit,
     world 2 the same certified optimum (checked against the exhaustive
     match_scan), the score within 1e-4. The sharded times beside the
     unsharded ones.
 26. [dp], after [shard]: data parallelism (Trainer(mesh=...),
     GlobalLocalizer.shard_extraction) in fp32 with TF32 off. One step on
     the fixed batch of 24 scans (122 480 points) or 24 768² images on
     each case (s2s all-device: K2 forward and backward; s2s host stats:
     K1; ResNet18 i2i under its freeze mask, BatchNorm in the encoder),
     from the same weights as the unsharded trainer's step: world size 1
     over NCCL in this process and world size 2 over gloo (two ranks
     spawned by gloc3d_tpu_torch/parallel/launch.py, sharing the card),
     each held to the unsharded step (loss rtol 1e-4, the gradients within
     DP_GRAD_TOL of their norm and DP_TENSOR_TOL per tensor, beside the
     unsharded step's own change on its batch reversed), the world-2
     parameters bit-equal on both ranks; the step is train_step, which
     _train_batch takes after mining (the host-stats path bins each rank's
     rows on the host); shard_extraction of the located map's 16
     keyframes, host stats and all-device, of the aligned map's 16
     (align_ground=True) and of 16 of the i2i case's images = the
     unsharded extract (descriptors 1e-5, a world-2 rank's images against
     the unsharded call on the same 8, cuDNN choosing its algorithms by
     batch size; BEV images, ground transforms and the localizer's
     generator state bit-equal); K1 / K2 launches of
     each path; host-clock ms of the step (_train_batch) and of the
     extraction at world sizes 1 and 2 beside the unsharded ones.
 27. [spatial], after [dp]: the i2i spatial partition
     (gloc3d_tpu_torch/parallel/spatial.py, GlobalLocalizer.shard_spatial)
     at PipelineConfig.i2i()'s full width (VGG16 + NetVLAD-FC, 768², the
     512-d descriptor) and the zoo encoders ResNet18, MobileNetV2 and
     AlexNet with the same head, fp32 with TF32 off, seeded weights with
     NetVLAD's centroids from each model's own local features, on the
     located world's BEVs rendered as images (16 keyframes, 8 queries):
     world size 1 over NCCL in this process and 2 over gloo (two ranks
     spawned on the one card), every spatial forward at B=1 and B=8 within
     its encoder's SPATIAL_TOL of the unsharded forward (max |diff| over
     max |value|), rank 1's descriptors = rank 0's bit for bit;
     shard_spatial + locate (B=1) and locate_batch (B=8) = the unsharded
     localizer; the B=1 VGG16 forward's ms at worlds 1 and 2 beside the
     unsharded one's (no speed-up can show with both ranks on one card).
 28. [device-sort], after phase 8: GlobalLocalizer(device_sort=True),
     the all-device binning by a device pillar sort
     (ops/voxelize.py::device_pillar_sort_stats: one packed-key torch.sort,
     searchsorted starts, the centroids' sums on K1 at C = 4) and the
     host-stats forward on the sorted rows (K1 on the 64-channel
     features), no K2. device_pillar_sort_stats on the card against the
     CPU on one full-pad tilted scan and on a batch of 24: order, ids,
     starts and counts bit-equal, centroids within DSORT_CENTROID_TOL;
     phase 6's aligned map (16 keyframes, 8 queries x 3) built and queried
     with the fp32 model both ways: the same keyframe and success on
     every call, the device-sort queries within phase 6's gates, keyframe
     descriptors within DSORT_DESC_TOL of the default's, K1 launched
     twice per extraction and K2 never on the device-sort run; every K1
     launch of the path (statistics at one scan and at batch 24, features
     at B = 1 and 16) against its plain version (1e-5 of L1 mass); the
     binning stage of one aligned extraction at B = 1 and 16, each way
     and by part (CUDA events, host syncs per call); locate's median both
     ways (fp32, and the bf16 serving model held to phase 6's gates).
 29. [surface], after phase 6, with no locate of its own (no kernel
     launch): phase 6's result poses, numpy as LocalizationResult.pose
     holds them, applied to their query's points on the card (within 1e-5
     m of the same fp32 call on the host, and within 8 fp32 ulps at the
     largest coordinate of to_matrix() applied in float64 on the host),
     Rigid3.identity(device="cuda") @ pose = pose, from_matrix(to_matrix())
     on the card within 2e-6; VGG16 with l2_normalize_output=True at 128²
     (features within 1e-5 card vs CPU, norms within 1e-5 of 1) and
     GatingContext(512, add_batch_norm=False) within 1e-6 card vs CPU,
     fp32 with TF32 off.
 30. [batched], after phase 8: locate_batch registers each stage in one
     matcher call over the batch (B queries x K candidates) and _align
     estimates every scan's ground in one call. On the host-stats map of
     phase 5 and the aligned map of phase 6 (bf16, default matcher) and
     their fp32 twins: locate_batch of the 8 queries = 8 locate calls in
     fp32 (same_results, the aligned ones on the same ground draws; in
     bf16 a batch of 8 and of 1 may round the descriptors apart and swap
     near-tied candidates, which is printed, not gated), and in bf16 its
     registration = the one-query registration on one extraction; ms per
     query of the batch
     and of the single calls (host clock, median of 5), kernels per call
     (torch.profiler), host syncs per call, and K1 / K2 launches of one
     batch (not counted in the kernels line); the ground of 16 aligned
     keyframe scans in one call against 16 B = 1 calls on the same draws
     (same valid, transforms within 1e-6), with times and kernels; the
     device memory peak of unstaged locate_batch at B = 8, K = 20.
 31. [fused-graph], after the fused phases: locate_fused as the JAX
     package runs it, one captured CUDA graph for the program and one for
     the full branch of staged_first, on every extraction variant (host
     stats, host stats aligned, all-device, aligned all-device,
     device_sort, images) and every bank (flat fp32 and int8, IVF fp32 and
     int8 at 4 cells, nprobe 4), fp32, the fm preset, on the located and
     aligned maps (16 keyframes; two of their queries and one 80 m from
     every keyframe, which takes stage 2) and the i2i one (PipelineConfig.
     i2i(), the located map's BEVs as images): the capture's seconds;
     every replay bit-equal to the same programs run eagerly, and = locate
     (same_results); host syncs per call 1, or 2 with stage 2 (one more on
     the aligned host-stats variant, its alignment program's fetch), the
     staging and replays under set_sync_debug_mode("error"); ms per query
     in the order graph, eager, eager, graph, and locate's; traced device
     busy / wall and kernels, graph and eager; peak allocated memory; K1 /
     K2 launches, those inside replays counted as the captured launches
     times the replays; every K1 / K2 launch of the eager program, which
     the replays equal bit for bit, against its plain version; a K2
     status word set bad in the replay's result raising after the fetch;
     a host read planted in the program failing its capture and
     locate_fused raising (no eager fallback); a keyframe added after a
     capture coming back. Times and the eager trace: FUSED_TIMED calls,
     the eager trace on the flat fp32 bank. [fused-cell] also
     prints the capture, graph against eager program times, the eager
     program's trace and the peak with and without the graphs.
 32. [knn], after phase 17: the ground estimate's k-NN normals kernel
     (csrc/knn_normals.cu) on the arguments estimate_ground_batch passes
     it for real tilted scans at (1, 4096, 3) and (8, 4096, 3)
     (record_launches): against its plain version (each row within the
     perturbation bound of its eigenvector, check_knn)
     and the chain it replaced, bit-equal over launches and in a graph
     replay; its kernel-only time ([kernel-times], L2-flushed and warm)
     beside the float64 bound, and the wrapper's, the plain version's and
     the replaced chain's times (CUDA events). Phases 6, 30 and 31 check
     its launches on the main paths: one a map-build batch and one a
     query on the aligned map, one a locate_batch, one a locate_fused
     query on the aligned variants (inside the replayed graph, or the
     host-stats variant's own alignment) and none on the others; the
     last line's kernels entry sums them. Every k-NN launch that
     record_launches catches (fused graph, eval) is held to the plain
     version too.
The kernel-only times of phase 17 come from complete traces only (every
device operation of every traced call, memsets included: K1 launches two
kernels and a memset a call, K2 four kernels); a timing with none in six
traces prints that it was not measured. `--k2-compare FILE.cu` also times
K2 v3's source (same C entry; built here, called through ctypes) beside the
current one, in the order earlier, current, current, earlier.
`python3 chip_smoke.py --kernels` runs phases 1-4, 17 and 32 only;
`python3 chip_smoke.py --knn` phases 1, 2 and 32 only;
`python3 chip_smoke.py --submap` phases 1 and 19 only;
`python3 chip_smoke.py --eval` phases 1, 2 and 23 only;
`python3 chip_smoke.py --cli` phases 1, 2 and 24 only;
`python3 chip_smoke.py --shard` phases 1, 2, 5 and 25 only;
`python3 chip_smoke.py --dp` phases 1, 2 and 26 only;
`python3 chip_smoke.py --device-sort` phases 1, 2 and 28 only;
`python3 chip_smoke.py --surface` phases 1, 2, 6 and 29 only;
`python3 chip_smoke.py --spatial` phases 1, 2 and 27 only;
`python3 chip_smoke.py --batched` phases 1, 2, 5, 6 and 30 only;
`python3 chip_smoke.py --fused-graph` phases 1, 2, 31 and [fused-cell]
only;
`--i2i-train`, `--pose-train` and `--packed` run phases 1, 2 and the
phase (or phases) named, alone;
`--seed N` seeds the map-scale rows (default 0).
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before those.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import textwrap
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K1_SOURCE = "gloc3d_tpu_torch/csrc/segment_sum.cu"
K1_REPLACES = "gloc3d_tpu/ops/pallas_scatter.py:106"
K2_SOURCE = "gloc3d_tpu_torch/csrc/pillar_bin_sums.cu"
K2_REPLACES = "gloc3d_tpu/ops/pallas_scatter.py:45"
KNN_SOURCE = "gloc3d_tpu_torch/csrc/knn_normals.cu"
KNN_REPLACES = "gloc3d_tpu/ops/ground.py:117 (no Pallas kernel)"
# device operations a call of K2 v3 makes (a memset and four kernels), for
# timing it beside the current version with --k2-compare
K2_V3_OPS = 5
N_KEYFRAMES, N_QUERIES = 16, 8
N_TRAIN_Q = 8  # training queries; 24 db scans (training_dataset)
POS_TOL_M, ROT_TOL_DEG = 1.0, 5.0
MAX_TILT, HEIGHTS = math.radians(3.0), (1.6, 1.9)
DZ_TOL_M, HEIGHT_TOL_M = 0.3, 0.15


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ----------------------------------------------------------------- world
def make_world(seed: int = 0, n_walls: int = 300, extent: float = 100.0,
               pts_per_m: float = 100.0) -> np.ndarray:
    """Vertical walls 5-15 m long, 0-3 m high, ~100 points per metre."""
    rng = np.random.RandomState(seed)
    walls = []
    for _ in range(n_walls):
        x0, y0 = rng.uniform(-extent, extent, 2)
        ang, length = rng.uniform(0, np.pi), rng.uniform(5, 15)
        m = int(length * pts_per_m)
        ts = rng.uniform(0, length, m)
        walls.append(np.stack([x0 + np.cos(ang) * ts, y0 + np.sin(ang) * ts,
                               rng.uniform(0.0, 3.0, m)], 1))
    return np.concatenate(walls).astype(np.float32)


def scan_at(world: np.ndarray, pose, n_pad: int, seed: int,
            view_radius: float = 70.0, n_ground: int = 40000):
    """Observe the world from (x, y, yaw): walls within range plus a
    sensor-centred ground ring (dense near the sensor, as a LiDAR sees it),
    shuffled and padded to n_pad rows of (x, y, z, intensity)."""
    x, y, yaw = pose
    rng = np.random.RandomState(seed)
    rel = world[:, :2] - np.array([x, y], np.float32)
    keep = np.linalg.norm(rel, axis=1) < view_radius
    c, s = np.cos(-yaw), np.sin(-yaw)
    px, py = rel[keep, 0], rel[keep, 1]
    wall = np.stack([c * px - s * py, s * px + c * py, world[keep, 2]], 1)
    r = rng.uniform(3.0, 40.0, n_ground)
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       np.full(n_ground, -1.73)], 1)
    pts = np.concatenate([wall, ground]).astype(np.float32)
    pts = pts[rng.permutation(len(pts))][:n_pad]
    out = np.zeros((n_pad, 4), np.float32)
    out[: len(pts), :3] = pts
    out[: len(pts), 3] = rng.uniform(0, 1, len(pts))
    mask = np.zeros(n_pad, np.float32)
    mask[: len(pts)] = 1.0
    return out, mask


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Rz(yaw)·Ry(pitch)·Rx(roll), the convention of quat_from_rpy."""
    cr, sr, cp, sp = math.cos(roll), math.sin(roll), math.cos(pitch), \
        math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def tilted_scan_at(world: np.ndarray, pose, attitude, n_pad: int, seed: int,
                   view_radius: float = 70.0, n_ground: int = 40000):
    """Observe the world from a sensor at (x, y, yaw) with (roll, pitch,
    height): walls within range standing on the ground plane z = 0 plus a
    sensor-centred ground ring, in the sensor frame (world → sensor by the
    inverse attitude), shuffled and padded to n_pad rows of (x, y, z,
    intensity)."""
    x, y, yaw = pose
    roll, pitch, height = attitude
    rng = np.random.RandomState(seed)
    rel = world[:, :2] - np.array([x, y], np.float32)
    keep = np.linalg.norm(rel, axis=1) < view_radius
    walls = np.concatenate([rel[keep], world[keep, 2:3]], 1)
    r = rng.uniform(3.0, 40.0, n_ground)
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       np.zeros(n_ground)], 1)
    pts = np.concatenate([walls, ground]).astype(np.float64)
    pts[:, 2] -= height
    pts = (pts @ rpy_matrix(roll, pitch, yaw)).astype(np.float32)
    pts = pts[rng.permutation(len(pts))][:n_pad]
    out = np.zeros((n_pad, 4), np.float32)
    out[: len(pts), :3] = pts
    out[: len(pts), 3] = rng.uniform(0, 1, len(pts))
    mask = np.zeros(n_pad, np.float32)
    mask[: len(pts)] = 1.0
    return out, mask


def pose6(torch, pose, attitude):
    """World pose of a tilted sensor as the port's Rigid3."""
    from gloc3d_tpu_torch.core.transforms import Rigid3, quat_from_rpy

    x, y, yaw = pose
    roll, pitch, height = attitude
    q = quat_from_rpy(*(torch.tensor(float(a), dtype=torch.float64)
                        for a in (roll, pitch, yaw)))
    return Rigid3(q, torch.tensor([x, y, height], dtype=torch.float64))


def bench_query_scan(n_pts: int):
    """bench.py::load_query_scan's synthetic scan (100 000 points uniform in
    the pillar grid), padded to n_pts."""
    pts = np.zeros((1, n_pts, 4), np.float32)
    rng = np.random.RandomState(0)
    n_real = 100000
    pts[0, :n_real, 0] = rng.uniform(-35, 35, n_real)
    pts[0, :n_real, 1] = rng.uniform(-20, 20, n_real)
    pts[0, :n_real, 2] = rng.uniform(-2, 3, n_real)
    pts[0, :n_real, 3] = rng.uniform(0, 1, n_real)
    mask = np.zeros((1, n_pts), np.float32)
    mask[0, :n_real] = 1.0
    return pts, mask


def relative_pose(db, q):
    """Ground-truth 2-D pose of the query in the db keyframe's frame."""
    c, s = np.cos(-db[2]), np.sin(-db[2])
    dx, dy = q[0] - db[0], q[1] - db[1]
    dyaw = math.remainder(q[2] - db[2], 2 * math.pi)
    return np.array([c * dx - s * dy, s * dx + c * dy]), dyaw


# ---------------------------------------------------------------- timing
def cuda_ms(torch, fn, iters: int, flush=None) -> float:
    """Mean device time of fn() over iters launches (CUDA events); with
    ``flush`` the L2 cache is overwritten before each launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    cold = flush is not None
    for _ in range(iters if cold else 1):
        if cold:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(1 if cold else iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def host_ms(torch, fn, iters: int) -> float:
    """Median host wall time of fn() ending in a device synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------- phases
def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda."
          "is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(card)
    # fp32 comparisons below must not run convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return name, card


def phase_build():
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_all()
    took = time.perf_counter() - t0
    for name, source in (("segment_sum", K1_SOURCE),
                         ("pillar_bin_sums", K2_SOURCE),
                         ("knn_normals", KNN_SOURCE)):
        regs = [ln.split(":", 1)[1].strip() for ln in build.build_log.get(
            name, "").splitlines() if "registers" in ln]
        print(f"[build] {source}: nvcc "
              f"{build.build_seconds.get(name, 0.0):.2f} s; ptxas: "
              f"{' | '.join(regs) or 'cached build'}")
    print(f"[build] the kernels built and loaded in {took:.2f} s "
          f"(one nvcc each, started together)")
    t0 = time.perf_counter()
    try:
        native.load_library()
    except RuntimeError as e:
        raise SmokeFailure(f"the port's host pass did not build: {e}")
    print(f"[build] host pass gloc3d_tpu_torch/native/scan_loader.cpp: "
          f"built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({os.path.relpath(native.library_path(), REPO)})")


def phase_k1(torch, cfg, world, card):
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    dev = torch.device("cuda")
    vc = cfg.voxel
    n = vc.max_points
    gen = torch.Generator(device=dev).manual_seed(0)

    def host_starts(pts, mask):
        counts = np.asarray(mask.sum(axis=1), np.int64)
        out = native.compute_voxel_stats_host_sorted(
            pts, counts, vc.xbound, vc.ybound, vc.zbound, crop=False)
        return torch.from_numpy(out[5]).to(dev)

    full = scan_at(world, (0.0, 0.0, 0.0), n, seed=1)
    sparse = scan_at(world, (0.0, 0.0, 0.0), n, seed=2)
    sparse[1][60000:] = 0.0  # 62k padding rows alias into pillar 0
    sparse[0][60000:] = 0.0
    other = scan_at(world, (20.0, -10.0, 1.0), n, seed=3)
    ids = torch.tensor([1, 1, 2, 2, 2, 4, 4, 9], device=dev)
    main_starts = host_starts(full[0][None], full[1][None])
    v = main_starts.shape[-1] - 1

    def one_segment(k):  # every row in segment k
        st = torch.full_like(main_starts, n)
        st[0, :k + 1] = 0
        return st

    def rand(b, c, rows=n):
        return torch.randn((b, rows, c), generator=gen, device=dev)

    main_x = rand(1, 64)
    cases = {
        "main path (1, 122480, 64)": (main_x, main_starts),
        "pillar 0 > 50k rows": (rand(1, 64), host_starts(sparse[0][None],
                                                         sparse[1][None])),
        "empty segments (8, 64), V=12": (rand(1, 64, 8), torch.searchsorted(
            ids, torch.arange(13, device=dev)).int()[None]),
        "every row in segment 0 (1, 122480, 64)": (rand(1, 64),
                                                   one_segment(0)),
        f"every row in segment {v // 2} (1, 122480, 64)": (
            rand(1, 64), one_segment(v // 2)),
        "batch 3, different starts (3, 122480, 64)": (
            rand(3, 64), host_starts(*(np.stack(a) for a in zip(
                full, sparse, other)))),
    }
    for c in (2, 4, 62, 66, 256):  # C=4: PointPillarSorted's payload
        cases[f"C={c} (1, 122480, {c}), the scan's starts"] = (
            rand(1, c), main_starts)
    worst, main_err = 0.0, None
    for label, (x, starts) in cases.items():
        rel, err = check_k1(torch, label, x, starts)
        empty = int((starts[..., 1:] == starts[..., :-1]).sum())
        p0 = (starts[..., 1] - starts[..., 0]).tolist()
        print(f"[k1] {label}: pillar-0 rows {p0}, empty segments "
              f"{empty}, max |kernel - plain| {err:.3e}, relative to "
              f"per-segment L1 mass {rel:.3e} (bound 1e-5)")
        worst = max(worst, rel)
        if main_err is None:
            main_err = err
    check(worst < 1e-5, f"K1 disagrees with its plain version: {worst:.3e}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = {}
    for label, fn in (("plain", ss.segment_sum_sorted_plain),
                      ("kernel", ss.segment_sum_sorted),
                      ("kernel", ss.segment_sum_sorted),
                      ("plain", ss.segment_sum_sorted_plain)):
        warm = cuda_ms(torch, lambda: fn(main_x, main_starts), 50)
        cold = cuda_ms(torch, lambda: fn(main_x, main_starts), 20, flush)
        times.setdefault(label, []).append((warm, cold))
    k = np.mean(times["kernel"], axis=0)
    p = np.mean(times["plain"], axis=0)
    print(f"[k1] time at (1, 122480, 64) on {card}: kernel {k[0]:.4f} ms "
          f"L2-warm / {k[1]:.4f} ms L2-flushed; plain {p[0]:.4f} / "
          f"{p[1]:.4f} ms (order plain, kernel, kernel, plain)")
    return main_err, float(k[1]), float(p[1]), (main_x, main_starts)


def check_k1(torch, label, x, starts):
    """Launch K1 on (x, starts) and hold it to its plain version: finite,
    empty segments exactly 0. Returns (max error relative to per-segment L1
    mass, max |kernel - plain|)."""
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    got = ss.segment_sum_sorted(x, starts)
    torch.cuda.synchronize()
    plain = ss.segment_sum_sorted_plain(x, starts)
    l1 = ss.segment_sum_sorted_plain(x.abs(), starts).double()
    diff = (got - plain).double().abs()
    check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite")
    empty = starts[..., 1:] == starts[..., :-1]
    check(bool((got[empty] == 0).all()),
          f"K1 {label}: empty segments not zero")
    return (float((diff / l1.clamp_min(1e-30)).max()),
            float(diff.max()))


def check_k2(torch, label, x, ids, nv):
    """Launch K2 on (x, ids, V) through its wrapper and three more times
    alone, and hold it to its plain version: finite, counts exactly equal,
    empty pillars exactly 0, the kernel's status clean (no id outside
    [0, V), every row placed), every launch bit-equal to the first. Returns
    (max error relative to per-pillar L1 mass, max |kernel - plain|, plain
    counts)."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    got, cnt = bs.pillar_bin_sums(x, ids, nv)
    status, same = None, True
    for _ in range(3):
        again, c_again, status = bs._launch(x, ids, nv)
        same = same and torch.equal(got, again) and torch.equal(cnt, c_again)
    torch.cuda.synchronize()
    st = status.cpu()
    check(int(st[:, 0].sum()) == 0 and bool((st[:, 3] == ids.shape[-1]).all()),
          f"K2 {label}: the kernel's status {st.tolist()} is not clean")
    check(same, f"K2 {label}: sums or counts differ between launches")
    plain, p_cnt = bs.pillar_bin_sums_plain(x, ids, nv)
    l1, _ = bs.pillar_bin_sums_plain(x.abs(), ids, nv)
    diff = (got - plain).double().abs()
    check(bool(torch.isfinite(got).all()), f"K2 {label}: non-finite")
    check(torch.equal(cnt, p_cnt), f"K2 {label}: counts differ")
    check(bool((got[p_cnt == 0] == 0).all()),
          f"K2 {label}: empty pillars not zero")
    return (float((diff / l1.double().clamp_min(1e-30)).max()),
            float(diff.max()), p_cnt)


def check_k2_batch(torch, feats, ids, v):
    """Item 3 of a batch of 24 (the main path's features and ids, each item
    permuted anew) against the same item binned alone: bit-equal sums and
    counts, and the batch held to its plain version."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    gen = torch.Generator(device=feats.device).manual_seed(24)
    perms = torch.stack([torch.randperm(ids.shape[-1], generator=gen,
                                        device=feats.device)
                         for _ in range(24)])
    big = feats[0][perms].contiguous()
    big_ids = ids[0][perms].contiguous()
    sums, cnt = bs.pillar_bin_sums(big, big_ids, v)
    alone, c_alone = bs.pillar_bin_sums(big[3:4].contiguous(),
                                        big_ids[3:4].contiguous(), v)
    torch.cuda.synchronize()
    same = torch.equal(sums[3:4], alone) and torch.equal(cnt[3:4], c_alone)
    plain, p_cnt = bs.pillar_bin_sums_plain(big, big_ids, v)
    l1, _ = bs.pillar_bin_sums_plain(big.abs(), big_ids, v)
    rel = float(((sums - plain).double().abs()
                 / l1.double().clamp_min(1e-30)).max())
    print(f"[k2] batch of 24 {tuple(big.shape)}: item 3 bit-equal to it "
          f"binned alone {same}; counts equal {torch.equal(cnt, p_cnt)}, "
          f"relative to per-pillar L1 mass {rel:.3e} (bound 1e-5)")
    check(same, "K2: item 3 of a batch of 24 differs from it binned alone")
    check(torch.equal(cnt, p_cnt) and rel < 1e-5,
          f"K2 batch of 24 disagrees with its plain version: {rel:.3e}")
    return rel


def check_k2_bad_ids(torch, feats, ids, v):
    """Three planted out-of-range ids: the wrapper raises ValueError from
    the kernel's own status, naming the count, the first bad flat row and
    its id beside the host's reading of the same ids."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    n = ids.shape[-1]
    bad = ids.clone()
    rows = (4100, 9000, 60000)
    for r, val in zip(rows, (v, -1, 99999)):
        bad[0, r] = val
    try:
        bs.pillar_bin_sums(feats, bad, v)
    except ValueError as e:
        msg = str(e)
    else:
        raise SmokeFailure("K2: planted out-of-range ids did not raise")
    want = (f"the kernel read 3 of {n} ids outside [0, {v}) (first at flat "
            f"row {rows[0]}, id {v}); read back to the host they span [-1, "
            f"99999], 3 of {n} out of range (first at flat rows "
            f"{list(rows)}")
    print(f"[k2] planted out-of-range ids raise: {msg}")
    check(msg.startswith(want), f"K2's out-of-range message: {msg!r}")


def reset_launches(*counters) -> None:
    """Zero a kernel wrapper's launches and the launches replays of its
    captured CUDA graphs ran."""
    for c in counters:
        c.launches = c.replayed = 0


def launches_of(counter) -> int:
    """A kernel's launches: through its wrapper, and inside replays of
    captured CUDA graphs (the captured launches times the replays)."""
    return counter.launches + counter.replayed


def record_launches(fn):
    """Run fn() and return copies of the arguments of every K1, K2 and k-NN
    normals launch it made: {"K1": [(values, starts)], "K2": [(features,
    ids, V)], "KNN": [(points, ok, k)]}, whether through a plain wrapper or
    an autograd Function (the kernels still run; outside any counted
    window)."""
    from gloc3d_tpu_torch.kernels import bin_sums, knn_normals, segment_sum

    targets = {"K1": (segment_sum, "_launch"), "K2": (bin_sums, "_launch"),
               "KNN": (knn_normals, "_launch")}
    calls = {key: [] for key in targets}
    real = {key: getattr(mod, attr) for key, (mod, attr) in targets.items()}

    def recorder(key):
        def launch(*args):
            calls[key].append(tuple(
                a.detach().clone() if hasattr(a, "detach") else a
                for a in args))
            return real[key](*args)
        return launch

    for key, (mod, attr) in targets.items():
        setattr(mod, attr, recorder(key))
    try:
        fn()
    finally:
        for key, (mod, attr) in targets.items():
            setattr(mod, attr, real[key])
    return calls


# The k-NN normals against their plain version, each row within the
# perturbation bound of its smallest eigenvector: the two versions sum each
# covariance entry over the k neighbours in another order (each within
# k eps lambda_max of the exact sum), three entries bound the 2-norm of a
# row of the difference, and Davis-Kahan divides by the eigenvalue gap:
# |diff| <= KNN_ULPS_PER_K k eps lambda_max / (lambda_mid - lambda_min).
# On the ground estimate's scans the worst row reads 24 of the 60 (k = 10).
KNN_ULPS_PER_K = 6


def check_knn(torch, label, pts, ok, k):
    """Launch the k-NN normals on (points, ok, k) through the wrapper and
    hold each row to the plain version within its bound (KNN_ULPS_PER_K).
    Returns (max |kernel - plain|, the worst row's share of its bound)."""
    from gloc3d_tpu_torch.kernels import knn_normals as kn

    got = kn.knn_normals(pts, ok, k)
    cov = kn.knn_covariance_plain(pts, ok, k)
    diff = (got - kn._smallest_eigvec_3x3(cov)).abs().amax(-1).cpu()
    lam = torch.linalg.eigvalsh(cov.cpu())  # ascending
    bound = (KNN_ULPS_PER_K * k * float(np.finfo(np.float64).eps)
             * lam[..., 2] / (lam[..., 1] - lam[..., 0]))
    share = float(torch.where(diff == 0, 0.0, diff / bound).max())
    err = float(diff.max())
    check(share <= 1.0, f"{label}: the k-NN normals {err:.3e} from their "
          f"plain version, {share:.2f} of a row's bound "
          f"({KNN_ULPS_PER_K} k eps lambda_max / eigenvalue gap)")
    return err, share


def check_recorded(torch, label, key, args) -> float:
    """A launch that record_launches caught, against its plain version:
    K1 and K2 by the error relative to L1 mass (bound 1e-5), the k-NN
    normals row by row (check_knn). Returns the error."""
    if key == "KNN":
        return check_knn(torch, label, *args)[0]
    rel = (check_k1(torch, label, *args)[0] if key == "K1"
           else check_k2(torch, label, *args)[0])
    check(rel < 1e-5, f"{label} disagrees with its plain version: "
          f"{rel:.3e}")
    return rel


def phase_k2(torch, cfg, world, card, centroids):
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    dev = torch.device("cuda")
    n = cfg.voxel.max_points
    pts, mask = tilted_scan_at(world, (1.0, -2.0, 0.5), (0.03, -0.04, 1.75),
                               n, seed=5)
    # the fp32 model: full fp32 features, not bf16 values that sum exactly
    model = build_serving_model(torch, cfg, "float32", centroids)
    inputs, main_path = {}, {}
    for aligned in (False, True):
        loc = GlobalLocalizer(cfg, model, device=dev, host_stats=False,
                              align_ground=aligned)
        calls = record_launches(
            lambda: loc.extract(pts[None], mask[None]))["K2"]
        check(len(calls) == 2, f"K2 called {len(calls)} times per scan")
        tag = "aligned" if aligned else "raw"
        inputs[f"statistics (1, {n}, 4), {tag} scan"] = calls[0]
        inputs[f"features (1, {n}, 64), {tag} scan"] = calls[1]
        main_path = {"statistics": calls[0], "features": calls[1]}
    feats, ids, v = main_path["features"]
    gen = torch.Generator(device=dev).manual_seed(0)
    crowded = ids.clone()
    extra = torch.randperm(n, generator=gen, device=dev)[:90000]
    crowded[0, extra] = 0  # spread through the scan, as out-of-grid rows are
    small_ids = torch.tensor([[1, 1, 2, 2, 2, 4, 4, 9]], dtype=torch.int32,
                             device=dev)
    inputs["pillar 0 > 80k rows (1, 122480, 64)"] = (
        torch.randn(feats.shape, generator=gen, device=dev), crowded, v)
    inputs["empty pillars (1, 8, 64), V=12"] = (
        torch.randn((1, 8, 64), generator=gen, device=dev), small_ids, 12)
    inputs["every row in pillar 0 (1, 122480, 64)"] = (
        torch.randn(feats.shape, generator=gen, device=dev),
        torch.zeros_like(ids), v)
    for c in (1, 3, 4, 65, 256):
        inputs[f"C={c} (1, {n}, {c}), the scan's ids"] = (
            torch.randn((1, n, c), generator=gen, device=dev), ids, v)
    # rows that are not 16-byte aligned: the scalar-load specialisations
    odd = torch.empty(feats.numel() + 1, device=dev)[1:].view(feats.shape)
    odd.copy_(feats)
    inputs["features at a 4-byte offset (1, 122480, 64)"] = (odd, ids, v)
    crowded = ids.clone()
    crowded[0, torch.randperm(n, generator=gen, device=dev)[:50000]] = 4321
    inputs["50 000 rows in pillar 4321 (1, 122480, 64)"] = (
        torch.randn(feats.shape, generator=gen, device=dev), crowded, v)
    inputs["every row in pillar 7 (1, 122480, 64)"] = (
        torch.randn(feats.shape, generator=gen, device=dev),
        torch.full_like(ids, 7), v)
    inputs["ids in descending order (1, 122480, 64)"] = (
        torch.randn(feats.shape, generator=gen, device=dev),
        torch.sort(ids, dim=-1, descending=True)[0].contiguous(), v)
    wide_v = torch.randint(1, 30000, ids.shape, generator=gen, device=dev,
                           dtype=torch.int32)
    wide_v[ids == 0] = 0
    inputs["V = 30 000, three windows of the tiles' counts (1, 122480, 64)"] = (
        torch.randn(feats.shape, generator=gen, device=dev), wide_v, 30000)
    perm = torch.randperm(n, generator=gen, device=dev)
    inputs["the main-path scan, rows permuted (1, 122480, 64)"] = (
        feats[:, perm].contiguous(), ids[:, perm].contiguous(), v)

    worst, main_err = 0.0, None
    for label, (x, i, nv) in inputs.items():
        rel, err, p_cnt = check_k2(torch, label, x, i, nv)
        print(f"[k2] {label}: pillar-0 rows {int(p_cnt[0, 0])}, empty "
              f"pillars {int((p_cnt == 0).sum())} of {nv}, counts equal, max "
              f"|kernel - plain| {err:.3e}, relative to per-pillar L1 mass "
              f"{rel:.3e} (bound 1e-5)")
        worst = max(worst, rel)
        if label.startswith("pillar 0"):
            check(int(p_cnt[0, 0]) > 80000, "the crowded case has <= 80k "
                  "rows in pillar 0")
        if label.startswith("50 000"):
            check(int(p_cnt[0, 4321]) >= 50000, "the crowded case has < 50k "
                  "rows in pillar 4321")
        if x is main_path["features"][0]:
            main_err = err
    check(worst < 1e-5, f"K2 disagrees with its plain version: {worst:.3e}")
    print(f"[k2] every case above: the kernel's status clean, every pillar "
          f"and the counts bit-equal over four launches")
    check_k2_batch(torch, feats, ids, v)
    check_k2_bad_ids(torch, feats, ids, v)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = {}
    for label in ("statistics", "features"):
        x, i, nv = main_path[label]
        per = {}
        for kind, fn in (("plain", bs.pillar_bin_sums_plain),
                         ("kernel", bs._launch), ("kernel", bs._launch),
                         ("plain", bs.pillar_bin_sums_plain)):
            warm = cuda_ms(torch, lambda: fn(x, i, nv), 50)
            cold = cuda_ms(torch, lambda: fn(x, i, nv), 20, flush)
            per.setdefault(kind, []).append((warm, cold))
        wrapper = cuda_ms(torch, lambda: bs.pillar_bin_sums(x, i, nv), 50)
        k = np.mean(per["kernel"], axis=0)
        p = np.mean(per["plain"], axis=0)
        times[label] = (float(k[1]), float(p[1]))
        print(f"[k2] time, {label} {tuple(x.shape)} of the aligned scan, on "
              f"{card}: kernel {k[0]:.4f} ms L2-warm / {k[1]:.4f} ms "
              f"L2-flushed; plain {p[0]:.4f} / {p[1]:.4f} ms (order plain, "
              f"kernel, kernel, plain); wrapper with its status read "
              f"{wrapper:.4f} ms L2-warm")
    return main_err, times["features"][0], times["features"][1], main_path


def check_k1_pillar0_determinism(torch, x, starts):
    """Four launches on the main path's input give bit-equal pillar-0 rows
    (K1 adds the partials of blocks inside one segment in a fixed order).
    Returns whether they did."""
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    first = ss.segment_sum_sorted(x, starts)[..., 0, :]
    same = all(torch.equal(first, ss.segment_sum_sorted(x, starts)[..., 0, :])
               for _ in range(3))
    print(f"[k1] main path {tuple(x.shape)}: pillar 0 over four launches "
          f"bit-equal {same} ({int(starts[0, 1] - starts[0, 0])} rows)")
    check(same, "K1: pillar 0 differs between launches")
    return same


def check_k2_determinism(torch, main_path):
    """Four launches on the same input give bit-equal sums in every pillar
    and bit-equal counts (K2 adds every pillar's rows in a fixed order).
    Run on both of the main path's binnings. Returns whether they did."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    for label, (x, ids, v) in main_path.items():
        first = bs.pillar_bin_sums(x, ids, v)
        same = all(
            torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
            for again in (bs.pillar_bin_sums(x, ids, v) for _ in range(3)))
        print(f"[k2] {label} {tuple(x.shape)}: every pillar and the counts "
              f"over four launches bit-equal {same} "
              f"({int((first[1] > 0).sum())} non-empty pillars)")
        check(same, f"K2 {label}: sums or counts differ between launches")
    return True


def seeded_standard_model(torch, cfg, dtype: str):
    """The port's seeded init with non-trivial BatchNorm statistics (so
    that folding matters), BatchNorms unfolded, in eval mode."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params

    std = init_params(build_model(
        cfg.model.replace(fold_bn=False, compute_dtype=dtype), cfg.voxel),
        seed=0)
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for m in std.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return std.eval()


def vlad_centroids(torch, cfg, scans, device="cuda", seed=0):
    """NetVLAD's data init, as the reference initialises its clusters from
    local features: K normalised local features of the seeded fp32 encoder,
    sampled from the feature maps of ``scans``. The seeded init's
    centroids (uniform in [0, 1)) dwarf the unit-norm features, so every
    scan's descriptor is nearly the same (distances² ~1e-6) and retrieval
    would rank keyframes by rounding noise."""
    model = seeded_standard_model(torch, cfg, "float32").to(device)
    with torch.no_grad():
        feats = model.encoder(
            torch.from_numpy(np.stack([s[0] for s in scans])).to(device),
            torch.from_numpy(np.stack([s[1] for s in scans])).to(device))
    f = torch.nn.functional.normalize(
        feats.reshape(-1, feats.shape[-1]).float(), dim=-1).cpu()
    pick = torch.randperm(f.shape[0], generator=torch.Generator(
    ).manual_seed(seed))[: cfg.model.num_clusters]
    return f[pick]


def build_serving_model(torch, cfg, dtype: str, centroids=None,
                        alpha: float = 30.0):
    """The folded serving model from the port's seeded init: seed the
    standard model, give NetVLAD ``centroids`` (and assignment weights
    alpha·centroids) where given, fold its BatchNorms, load into the
    fold_bn=True model."""
    from gloc3d_tpu_torch.convert import fold_batch_norm
    from gloc3d_tpu_torch.models.descriptor import build_model

    std = seeded_standard_model(torch, cfg, dtype)
    if centroids is not None:
        with torch.no_grad():
            std.pool.centroids.copy_(centroids)
            std.pool.conv.weight.copy_(alpha * centroids[:, :, None, None])
    served = build_model(cfg.model.replace(fold_bn=True, compute_dtype=dtype),
                         cfg.voxel)
    served.load_state_dict(fold_batch_norm(std.state_dict()))
    return served.eval()


def build_map(torch, cfg, model, kf, device="cuda", **kw):
    """A GlobalLocalizer on ``device`` with its map built from the scans
    ``kf`` in batches of 4."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    loc = GlobalLocalizer(cfg, model, device=torch.device(device), **kw)
    for i in range(0, len(kf), 4):
        loc.add_keyframes(np.stack([k[0] for k in kf[i:i + 4]]),
                          np.stack([k[1] for k in kf[i:i + 4]]))
    return loc


def located_world_scans(world, n: int):
    """16 keyframes on a 5 m grid with random headings and 8 queries
    within it at random headings: ((poses, scans) of the keyframes, (poses,
    scans) of the queries)."""
    rng = np.random.RandomState(7)
    grid = np.linspace(-7.5, 7.5, 4)
    kf_poses = [(x, y, rng.uniform(-np.pi, np.pi)) for x in grid
                for y in grid]
    q_poses = [(rng.uniform(-6, 6), rng.uniform(-6, 6),
                rng.uniform(-np.pi, np.pi)) for _ in range(N_QUERIES)]
    kf = [scan_at(world, p, n, seed=100 + i) for i, p in enumerate(kf_poses)]
    qs = [scan_at(world, p, n, seed=200 + i) for i, p in enumerate(q_poses)]
    return (kf_poses, kf), (q_poses, qs)


def check_located(tag, results, kf_poses, q_poses, top_k):
    """Every result localized within POS_TOL_M / ROT_TOL_DEG of the
    ground-truth 2-D pose relative to the keyframe it returns."""
    worst_pos = worst_rot = 0.0
    for i, (res, qp) in enumerate(zip(results, q_poses)):
        check(res.success, f"{tag} query {i} did not localize "
              f"(score {res.match_score:.3f})")
        check(len(res.candidates) == top_k, "top-k length")
        t_gt, yaw_gt = relative_pose(kf_poses[res.db_index], qp)
        q = res.pose.rotation
        yaw = 2.0 * math.atan2(q[3], q[0])
        pos_err = float(np.linalg.norm(res.pose.translation[:2] - t_gt))
        rot_err = abs(math.degrees(math.remainder(yaw - yaw_gt, 2 * math.pi)))
        worst_pos, worst_rot = max(worst_pos, pos_err), max(worst_rot,
                                                            rot_err)
        print(f"[{tag}] query {i}: db {res.db_index} (top-1 "
              f"{res.candidates[0]}), score {res.match_score:.3f}, "
              f"error {pos_err:.3f} m / {rot_err:.3f} deg")
        check(pos_err < POS_TOL_M and rot_err < ROT_TOL_DEG,
              f"{tag} query {i}: pose error {pos_err:.3f} m / "
              f"{rot_err:.3f} deg")
    print(f"[{tag}] {len(results)}/{len(results)} localized; worst error "
          f"{worst_pos:.3f} m / {worst_rot:.3f} deg "
          f"(bound {POS_TOL_M} m / {ROT_TOL_DEG} deg)")


def phase_located_query(torch, cfg, lq_set, centroids, device="cuda"):
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    n = cfg.voxel.max_points
    (kf_poses, kf), (q_poses, qs) = lq_set
    fill = np.mean([q[1].sum() for q in qs]) / n
    print(f"[locate] {len(kf)} keyframes, {len(qs)} queries; scans fill "
          f"{fill:.1%} of the {n}-point pad; gates min_score "
          f"{cfg.match.min_score}, "
          f"min_overlap_pixels {cfg.match.min_overlap_pixels}")

    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    reset_launches(ss.segment_sum_sorted)
    loc = build_map(torch, cfg, model, kf, device, host_stats=True)
    results = [loc.locate(*q) for q in qs]
    launches = launches_of(ss.segment_sum_sorted)
    print(f"[locate] K1 launches on the main path: {launches}")
    check(launches >= N_KEYFRAMES // 4 + N_QUERIES,
          f"K1 launched {launches} times on the main path")

    check(len(loc.bank) == N_KEYFRAMES, "bank size")
    descs = loc.bank.data
    check(bool(torch.isfinite(descs).all()) and descs.shape == (
        N_KEYFRAMES, cfg.index.dim), "keyframe descriptors")
    check_located("locate", results, kf_poses, q_poses, cfg.index.top_k)
    return loc, kf, qs, launches


def phase_reference(torch, cfg, kf, qs, centroids):
    """One query on the card against the same port code on the CPU (plain
    kernel versions), in fp32 with TF32 off."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    out = {}
    for dev in ("cuda", "cpu"):
        model = build_serving_model(torch, cfg, "float32", centroids)
        loc = GlobalLocalizer(cfg, model, device=torch.device(dev),
                              host_stats=True)
        loc.add_keyframes(np.stack([k[0] for k in kf[:2]]),
                          np.stack([k[1] for k in kf[:2]]))
        res = loc.locate(*qs[0])
        out[dev] = (loc.bank.data.cpu().numpy(), res)
    d_gpu, r_gpu = out["cuda"]
    d_cpu, r_cpu = out["cpu"]
    derr = float(np.abs(d_gpu - d_cpu).max())
    print(f"[reference] fp32 descriptors card vs CPU: max |diff| {derr:.2e} "
          f"(bound atol 2e-4 + rtol 2e-3); success {r_gpu.success}/"
          f"{r_cpu.success}, db {r_gpu.db_index}/{r_cpu.db_index}")
    check(np.allclose(d_gpu, d_cpu, atol=2e-4, rtol=2e-3),
          "card descriptors disagree with the CPU reference")
    check(r_gpu.success == r_cpu.success
          and r_gpu.db_index == r_cpu.db_index, "card locate != CPU locate")
    if r_gpu.success:
        perr = float(np.abs(r_gpu.match_xy_yaw - r_cpu.match_xy_yaw).max())
        print(f"[reference] match (dx, dy, yaw) card vs CPU: max |diff| "
              f"{perr:.2e}")
        check(perr <= 0.2 + 1e-3, "card pose disagrees with the CPU pose")


def aligned_world_scans(world, n: int):
    """16 keyframes on a 0.75 m grid and 8 queries within 0.5 m of a
    keyframe, each scan with its own roll and pitch (±3°) and sensor height
    (1.6-1.9 m), all headed within ±0.3 rad of one direction.

    The map is compact because the reference's composition (kept by the
    port) takes roll, pitch and dz from the two ground frames alone: dz
    misses the db frame's tilt times the horizontal offset, and roll/pitch
    miss the heading difference. With exact estimates that alone is, over
    every query-keyframe pair of this layout, at most 0.19 m and 1.9° (at
    5 m spacing 1.2 m), and the seeded-init model retrieves no better than
    any keyframe of the map."""
    rng = np.random.RandomState(11)
    grid = np.linspace(-1.125, 1.125, 4)
    heading = 0.7

    def attitude():
        return (rng.uniform(-MAX_TILT, MAX_TILT),
                rng.uniform(-MAX_TILT, MAX_TILT), rng.uniform(*HEIGHTS))

    kf_poses = [(x, y, heading + rng.uniform(-0.3, 0.3)) for x in grid
                for y in grid]
    kf_att = [attitude() for _ in kf_poses]
    near = rng.permutation(len(kf_poses))[:N_QUERIES]
    q_poses = [(kf_poses[j][0] + rng.uniform(-0.5, 0.5),
                kf_poses[j][1] + rng.uniform(-0.5, 0.5),
                heading + rng.uniform(-0.3, 0.3)) for j in near]
    q_att = [attitude() for _ in q_poses]
    kf = [tilted_scan_at(world, p, a, n, seed=300 + i)
          for i, (p, a) in enumerate(zip(kf_poses, kf_att))]
    qs = [tilted_scan_at(world, p, a, n, seed=400 + i)
          for i, (p, a) in enumerate(zip(q_poses, q_att))]
    return (kf_poses, kf_att, kf), (q_poses, q_att, qs)


def run_aligned(torch, cfg, model, kf, qs, host_stats: bool, seed: int = 0,
                device="cuda"):
    """Build the aligned map in batches of 4 and locate every query."""
    loc = build_map(torch, cfg, model, kf, device, host_stats=host_stats,
                    align_ground=True, seed=seed)
    return loc, [loc.locate(*q) for q in qs]


def check_aligned(torch, tag, results, kf_set, q_set):
    """Every result localized in 6-DoF within POS_TOL_M / ROT_TOL_DEG of
    the ground truth relative to the keyframe it returns, |dz| < DZ_TOL_M."""
    from gloc3d_tpu_torch.eval.registration import registration_errors

    kf_poses, kf_att, _ = kf_set
    q_poses, q_att, _ = q_set
    worst = [0.0, 0.0, 0.0]
    for i, (res, qp, qa) in enumerate(zip(results, q_poses, q_att)):
        check(res.success, f"{tag} query {i} did not localize "
              f"(score {res.match_score:.3f})")
        gt = pose6(torch, kf_poses[res.db_index], kf_att[res.db_index]
                   ).inverse().compose(pose6(torch, qp, qa))
        e_pos, e_rot = (float(e) for e in registration_errors(res.pose, gt))
        dz = abs(float(res.pose.translation[2]) - float(gt.translation[2]))
        worst = [max(a, b) for a, b in zip(worst, (e_pos, e_rot, dz))]
        print(f"[{tag}] query {i}: db {res.db_index} (top-1 "
              f"{res.candidates[0]}), score {res.match_score:.3f}, 6-DoF "
              f"error {e_pos:.3f} m / {e_rot:.3f} deg, |dz error| {dz:.3f} m")
        check(e_pos < POS_TOL_M and e_rot < ROT_TOL_DEG and dz < DZ_TOL_M,
              f"{tag} query {i}: error {e_pos:.3f} m / {e_rot:.3f} deg / "
              f"dz {dz:.3f} m")
    print(f"[{tag}] {len(results)}/{len(results)} localized in 6-DoF; worst "
          f"{worst[0]:.3f} m / {worst[1]:.3f} deg, |dz| {worst[2]:.3f} m "
          f"(bounds {POS_TOL_M} m / {ROT_TOL_DEG} deg / {DZ_TOL_M} m)")


def phase_aligned_query(torch, cfg, model, kf_set, q_set):
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import knn_normals as kn

    kf_poses, kf_att, kf = kf_set
    q_poses, q_att, qs = q_set
    print(f"[aligned] {len(kf)} keyframes, {len(qs)} queries; roll/pitch "
          f"within ±{math.degrees(MAX_TILT):.0f} deg, sensor heights "
          f"{HEIGHTS[0]}-{HEIGHTS[1]} m; ground RANSAC "
          f"{cfg.ground.num_candidates} candidates x "
          f"{cfg.ground.ransac_iters} hypotheses")
    reset_launches(bs.pillar_bin_sums, kn.knn_normals)
    loc, results = run_aligned(torch, cfg, model, kf, qs, host_stats=False)
    launches = launches_of(bs.pillar_bin_sums)
    knn = launches_of(kn.knn_normals)
    need = 2 * (len(kf) // 4 + len(qs))
    # the ground estimate: one k-NN launch a map-build batch and a query
    want_knn = -(-len(kf) // 4) + len(qs)
    print(f"[aligned] K2 launches on the all-device aligned path: "
          f"{launches} (at least {need}); k-NN normals launches {knn} "
          f"(want {want_knn}: one a batch of 4 keyframes and one a query)")
    check(launches >= need, f"K2 launched {launches} times, < {need}")
    check(knn == want_knn, f"[aligned] the k-NN normals launched {knn} "
          f"times, want {want_knn}")

    worst_h = 0.0
    for i, (k, att) in enumerate(zip(loc.keyframes, kf_att)):
        check(k.ground is not None, f"keyframe {i} has no ground frame")
        worst_h = max(worst_h, abs(float(k.ground.translation[2]) - att[2]))
    print(f"[aligned] keyframe heights: worst error {worst_h:.4f} m "
          f"(bound {HEIGHT_TOL_M} m)")
    check(worst_h < HEIGHT_TOL_M, f"keyframe height error {worst_h:.3f} m")

    check_aligned(torch, "aligned", results, kf_set, q_set)
    return loc, results, launches, knn


SURFACE_CARD_TOL_M = 1e-5  # pose @ card points against the same fp32 host call
SURFACE_ULPS = 8           # fp32 rounding of the rotation at the largest |x|
SURFACE_ROUND_TRIP = 2e-6  # from_matrix(to_matrix()), quaternion entries
SURFACE_VGG_TOL = 1e-5     # l2-normalised VGG16 features, card against CPU
SURFACE_GATING_TOL = 1e-6


def phase_surface(torch, results, qs, card, seed: int = 21):
    """[surface]: the last of the JAX package's surface that the port took
    up, on the card. The numpy poses that phase 6's aligned ``locate``
    returned (no new locate, so no kernel launch) applied to the query's
    points on the card: against the same fp32 call on the host, and against
    ``to_matrix()`` applied in float64 on the host within fp32's rounding
    at the largest coordinate (8 ulps: a 70 m point rotated in fp32 lies
    ~3e-5 m from the fp64 product); ``Rigid3.identity(device="cuda") @
    pose`` = pose; ``from_matrix(to_matrix())`` on the card. Then VGG16
    with ``l2_normalize_output=True`` at 128² and ``GatingContext(
    add_batch_norm=False)`` at D = 512, card against CPU in fp32 with TF32
    off, from seeded weights."""
    from gloc3d_tpu_torch.core.transforms import Rigid3
    from gloc3d_tpu_torch.models.descriptor import init_params
    from gloc3d_tpu_torch.models.encoders import build_image_encoder
    from gloc3d_tpu_torch.models.netvlad import GatingContext

    check(not (torch.backends.cudnn.allow_tf32
               or torch.backends.cuda.matmul.allow_tf32),
          "[surface] TF32 is on")
    t0 = time.perf_counter()
    eps = float(np.finfo(np.float32).eps)
    ident = Rigid3.identity(device="cuda")
    worst = {"card_vs_host_m": 0.0, "vs_fp64_matrix_m": 0.0,
             "vs_fp64_bound_m": 0.0, "round_trip_quat": 0.0,
             "round_trip_translation": 0.0}
    for i, (res, (pts, mask)) in enumerate(zip(results, qs)):
        pose = res.pose
        check(isinstance(pose.rotation, np.ndarray)
              and isinstance(pose.translation, np.ndarray),
              f"[surface] query {i}: the result's pose is not numpy")
        xyz = np.ascontiguousarray(pts[mask > 0, :3])
        on_card = pose @ torch.from_numpy(xyz).cuda()
        check(on_card.is_cuda, f"[surface] query {i}: pose @ card points "
              f"ran on {on_card.device}")
        got = on_card.cpu().double().numpy()
        host = (pose @ xyz).double().numpy()
        m = pose.to_matrix().double().numpy()
        want = xyz.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        bound = SURFACE_ULPS * eps * max(1.0, float(np.abs(xyz).max()))
        d_host = float(np.abs(got - host).max())
        d_f64 = float(np.abs(got - want).max())
        check(d_host <= SURFACE_CARD_TOL_M, f"[surface] query {i}: pose @ "
              f"card points {d_host:.2e} m from the host's")
        check(d_f64 <= bound, f"[surface] query {i}: pose @ card points "
              f"{d_f64:.2e} m from the fp64 matrix (bound {bound:.2e})")
        on = ident @ pose
        check(on.rotation.is_cuda and on.translation.is_cuda
              and np.array_equal(on.rotation.cpu().numpy(), pose.rotation)
              and np.array_equal(on.translation.cpu().numpy(),
                                 pose.translation),
              f"[surface] query {i}: identity @ pose != pose")
        back = Rigid3.from_matrix(on.to_matrix())
        bq = back.rotation.cpu().numpy()
        dq = min(float(np.abs(bq - pose.rotation).max()),
                 float(np.abs(bq + pose.rotation).max()))
        dt = float(np.abs(back.translation.cpu().numpy()
                          - pose.translation).max())
        check(dq <= SURFACE_ROUND_TRIP and dt <= SURFACE_ROUND_TRIP,
              f"[surface] query {i}: from_matrix(to_matrix()) off by "
              f"{dq:.2e} (quaternion), {dt:.2e} m")
        for key, v in (("card_vs_host_m", d_host), ("vs_fp64_matrix_m", d_f64),
                       ("vs_fp64_bound_m", bound), ("round_trip_quat", dq),
                       ("round_trip_translation", dt)):
            worst[key] = max(worst[key], v)
    print(f"[surface] {len(results)} aligned result poses (numpy) @ their "
          f"query's points on the card: {worst['card_vs_host_m']:.2e} m "
          f"from the host's fp32 call (bound {SURFACE_CARD_TOL_M:.0e}), "
          f"{worst['vs_fp64_matrix_m']:.2e} m from to_matrix() in fp64 "
          f"(bound {SURFACE_ULPS} ulps at the largest |x|, "
          f"{worst['vs_fp64_bound_m']:.2e} m); identity(cuda) @ pose = "
          f"pose; from_matrix(to_matrix()) {worst['round_trip_quat']:.2e} "
          f"quaternion, {worst['round_trip_translation']:.2e} m (bound "
          f"{SURFACE_ROUND_TRIP:.0e})")

    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(2, 128, 128, 3) > 0.2).astype(np.float32))
    enc = init_params(build_image_encoder(
        "vgg16", torch.float32, l2_normalize_output=True), seed=seed).eval()
    with torch.no_grad():
        f_cpu = enc(x)
        f_card = enc.cuda()(x.cuda()).cpu()
    vgg_err = float((f_card - f_cpu).abs().max())
    norm_err = float((torch.linalg.vector_norm(f_card, dim=-1) - 1.0).abs()
                     .max())
    print(f"[surface] VGG16 l2_normalize_output=True, fp32, 128² x 2: "
          f"{tuple(f_card.shape)}, card vs CPU max |diff| {vgg_err:.2e} "
          f"(bound {SURFACE_VGG_TOL:.0e}); norms within {norm_err:.2e} of 1 "
          f"(bound 1e-05)")
    check(vgg_err <= SURFACE_VGG_TOL, "[surface] VGG16 l2 features: card "
          "!= CPU")
    check(norm_err <= 1e-5, "[surface] VGG16 l2 features not unit")

    d = rng.randn(8, 512).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    gate = init_params(GatingContext(512, add_batch_norm=False),
                       seed=seed).eval()
    with torch.no_grad():
        g_cpu = gate(d)
        g_card = gate.cuda()(d.cuda()).cpu()
    gate_err = float((g_card - g_cpu).abs().max())
    print(f"[surface] GatingContext(512, add_batch_norm=False) on 8 unit "
          f"descriptors: card vs CPU max |diff| {gate_err:.2e} (bound "
          f"{SURFACE_GATING_TOL:.0e})")
    check(gate.bn1 is None and gate_err <= SURFACE_GATING_TOL,
          "[surface] GatingContext(add_batch_norm=False): card != CPU")
    seconds = time.perf_counter() - t0
    print(f"[surface] {seconds:.1f} s; {card}")
    return {**worst, "poses": len(results), "vgg16_l2_card_vs_cpu": vgg_err,
            "vgg16_l2_norm_err": norm_err, "gating_card_vs_cpu": gate_err,
            "seconds": seconds}


def phase_aligned_hoststats(torch, cfg, kf_set, q_set, centroids):
    """The aligned queries through host_stats=True against host_stats=False,
    both with the fp32 model: in bf16 the two binnings' last-bit
    differences can reorder keyframes of this compact map whose
    descriptors tie within bf16 rounding."""
    from gloc3d_tpu_torch.eval.registration import registration_errors
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    model = build_serving_model(torch, cfg, "float32", centroids)
    _, dev_results = run_aligned(torch, cfg, model, kf_set[2], q_set[2],
                                 host_stats=False)
    reset_launches(ss.segment_sum_sorted)
    _, results = run_aligned(torch, cfg, model, kf_set[2], q_set[2],
                             host_stats=True)
    launches = launches_of(ss.segment_sum_sorted)
    worst_t = worst_r = 0.0
    for i, (a, b) in enumerate(zip(results, dev_results)):
        check(a.success and b.success and a.db_index == b.db_index,
              f"host-stats aligned query {i}: db {a.db_index} vs "
              f"{b.db_index}")
        e_t, e_r = (float(e) for e in registration_errors(a.pose, b.pose))
        worst_t, worst_r = max(worst_t, e_t), max(worst_r, e_r)
    print(f"[aligned-host] fp32 model, host_stats=True vs False: same "
          f"keyframe for {len(results)}/{len(results)} queries; pose within "
          f"{worst_t:.4f} m / {worst_r:.4f} deg (bound 0.2 m / 0.5 deg; "
          f"0.0810 deg is the metric's arccos floor); K1 launches "
          f"{launches}")
    check(worst_t < 0.2 and worst_r < 0.5, "host-stats aligned pose differs")
    check(launches >= len(kf_set[2]) // 4 + len(results),
          f"K1 launched {launches} times on the host-stats aligned path")


def phase_aligned_reference(torch, cfg, kf_set, q_set, centroids,
                            devices=("cuda", "cpu")):
    """One aligned query on the card against the same port code on the CPU
    (plain kernel versions), fp32 with TF32 off, the same draws."""
    out = {}
    kf, qs = kf_set[2][:2], q_set[2][:1]
    for dev in devices:
        model = build_serving_model(torch, cfg, "float32", centroids)
        loc, _ = run_aligned(torch, cfg, model, kf, [], host_stats=False,
                             seed=5, device=dev)
        _, _, bev, ground = loc.detect(qs[0][0][None], qs[0][1][None])
        res = loc.locate(*qs[0])
        out[dev] = (loc, bev, ground, res)
    (l_g, b_g, g_g, r_g), (l_c, b_c, g_c, r_c) = (out[d] for d in devices)
    gq = max(float((g_g.transform.rotation.cpu()
                    - g_c.transform.rotation).abs().max()),
             float((g_g.transform.translation.cpu()
                    - g_c.transform.translation).abs().max()))
    gk = max(float(np.abs(a.ground.rotation - b.ground.rotation).max())
             for a, b in zip(l_g.keyframes, l_c.keyframes))
    same_bev = bool(torch.equal(b_g.image.cpu(), b_c.image)) and all(
        np.array_equal(a.image, b.image)
        for a, b in zip(l_g.keyframes, l_c.keyframes))
    d_g, d_c = l_g.bank.data.cpu().numpy(), l_c.bank.data.cpu().numpy()
    derr = float(np.abs(d_g - d_c).max())
    print(f"[aligned-reference] card vs CPU: ground transform max |diff| "
          f"query {gq:.2e}, keyframes {gk:.2e}; BEV images equal "
          f"{same_bev}; fp32 descriptors max |diff| {derr:.2e} (bound atol "
          f"2e-4 + rtol 2e-3); success {r_g.success}/{r_c.success}, db "
          f"{r_g.db_index}/{r_c.db_index}")
    check(same_bev, "card BEV differs from the CPU BEV")
    check(np.allclose(d_g, d_c, atol=2e-4, rtol=2e-3),
          "card descriptors disagree with the CPU reference")
    check(r_g.success == r_c.success and r_g.db_index == r_c.db_index,
          "card aligned locate != CPU aligned locate")


DSORT_CENTROID_TOL = 1e-4  # m; K1's per-tile sums against index_add_'s
DSORT_DESC_TOL = 2e-5      # rtol = atol, JAX's bound between its two paths


def dsort_case(torch, cfg, scans, device):
    """device_pillar_sort_stats of ``scans`` on ``device``, with the
    arguments of every K1 launch it made there."""
    from gloc3d_tpu_torch.ops.voxelize import device_pillar_sort_stats

    vc = cfg.voxel
    pts = torch.from_numpy(np.stack([s[0] for s in scans])).to(device)
    mask = torch.from_numpy(np.stack([s[1] for s in scans])).to(device)
    out = []
    calls = record_launches(lambda: out.extend(device_pillar_sort_stats(
        pts, mask, vc.xbound, vc.ybound, vc.zbound)))["K1"]
    return [t.cpu() for t in out], calls


def binning_stages(torch, loc_default, loc_sorted, pts, mask):
    """The binning stage of one aligned extraction of the rows ``pts``,
    both ways, as the two forwards run it (pillar ids, statistics,
    per-point rows, the 64-channel feature mean, on the features each
    forward launches its kernel with): {name: fn}."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.ops.voxelize import (
        device_pillar_sort_stats, points_to_voxels,
        points_to_voxels_hoststats, scatter_mean_to_grid,
        segment_sum_sorted,
    )

    vc = loc_default.cfg.voxel
    bounds = (vc.xbound, vc.ybound, vc.zbound)
    k2 = record_launches(lambda: loc_default.model(pts, mask))["K2"]
    st = device_pillar_sort_stats(pts, mask, *bounds)
    k1 = record_launches(lambda: loc_sorted.model(
        st[0], st[1], voxel_stats=(st[2], st[4], st[5], st[3])))["K1"]
    check(len(k2) == 2 and not record_launches(lambda: loc_sorted.model(
        st[0], st[1], voxel_stats=(st[2], st[4], st[5], st[3])))["K2"]
        and len(k1) == 1, "[device-sort] launches of the two forwards")
    feats_k2, ids, v = k2[1]
    feats_k1 = k1[0][0]
    n = pts.shape[1]
    row_bits = max(1, (n - 1).bit_length())
    key = (ids << row_bits) | torch.arange(n, dtype=torch.int32,
                                           device=ids.device)

    def default():
        vox = points_to_voxels(pts[..., :3], mask, *bounds)
        return scatter_mean_to_grid(feats_k2, vox["voxel_indices"], v,
                                    counts=vox["raw_counts"])

    def sorted_():
        ps, vs, sid, starts, counts, cents = device_pillar_sort_stats(
            pts, mask, *bounds)
        points_to_voxels_hoststats(ps[..., :3], vs, sid, counts, cents,
                                   *bounds)
        return segment_sum_sorted(feats_k1, starts) / counts.clamp_min(
            1.0)[..., None]

    return {"default: K2 statistics + K2 features (stage)": default,
            "device sort: sort + statistics + 2 K1 (stage)": sorted_,
            "K2 statistics (wrapper, status read)":
                lambda: bs.pillar_bin_sums(*k2[0]),
            "K2 features (wrapper, status read)":
                lambda: bs.pillar_bin_sums(*k2[1]),
            "packed-key sort alone": lambda: torch.sort(key, dim=-1),
            "statistics (sort, searchsorted, K1 C=4)":
                lambda: device_pillar_sort_stats(pts, mask, *bounds),
            "K1 features (wrapper)":
                lambda: segment_sum_sorted(feats_k1, st[3])}


def phase_device_sort(torch, cfg, kf_set, q_set, centroids, card):
    """GlobalLocalizer(device_sort=True): the device pillar sort card vs
    CPU, K1 at the launches it makes, the aligned map built and queried
    both ways, and the binning stage's time. Returns the K1 launches of the
    device-sort map's run and the record."""
    from gloc3d_tpu_torch.eval.registration import registration_errors
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    rec = {"card": card}
    kf, qs = kf_set[2], q_set[2]
    # 1. card against CPU: one full-pad scan and a batch of 24
    k1_cases = {}
    for label, scans in (("one scan", kf[:1]), ("batch 24", kf + qs)):
        got, calls = dsort_case(torch, cfg, scans, "cuda")
        want, _ = dsort_case(torch, cfg, scans, "cpu")
        same = all(torch.equal(a, b) for a, b in zip(got[:5], want[:5]))
        cerr = float((got[5] - want[5]).abs().max())
        p0 = int(got[3][:, 1].max())
        print(f"[device-sort] {label} {tuple(got[0].shape)} card vs CPU: "
              f"order, ids, starts and counts bit-equal {same}; centroids "
              f"max |diff| {cerr:.3e} m (bound {DSORT_CENTROID_TOL}); "
              f"pillar-0 rows up to {p0}; K1 launches {len(calls)}")
        check(same, f"[device-sort] {label}: the card's sort differs")
        check(cerr < DSORT_CENTROID_TOL,
              f"[device-sort] {label}: centroids {cerr:.3e} m")
        check(len(calls) == 1 and calls[0][0].shape[-1] == 4,
              f"[device-sort] {label}: K1 launches {len(calls)}")
        k1_cases[f"statistics C=4, {label}"] = calls[0][:2]
        rec[f"centroid_err_{label.replace(' ', '_')}"] = cerr

    # 2. the aligned map both ways, fp32: same answers, K1 only
    model = build_serving_model(torch, cfg, "float32", centroids)
    default = build_map(torch, cfg, model, kf, align_ground=True)
    reset_launches(ss.segment_sum_sorted)
    reset_launches(bs.pillar_bin_sums)
    dsorted = build_map(torch, cfg, model, kf, align_ground=True,
                        device_sort=True)
    check(dsorted.device_sort, "[device-sort] the option was dropped")
    k1_launches = launches_of(ss.segment_sum_sorted)
    k2_launches = launches_of(bs.pillar_bin_sums)
    times = {"default": [], "device sort": []}
    results = {"default": [], "device sort": []}
    for _ in range(3):
        for q in qs:
            for key, loc in (("default", default), ("device sort", dsorted)):
                reset_launches(ss.segment_sum_sorted)
                reset_launches(bs.pillar_bin_sums)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results[key].append(loc.locate(*q))
                times[key].append((time.perf_counter() - t0) * 1e3)
                if key == "device sort":  # the device-sort run's launches
                    k1_launches += launches_of(ss.segment_sum_sorted)
                    k2_launches += launches_of(bs.pillar_bin_sums)
    extractions = len(kf) // 4 + len(results["device sort"])
    print(f"[device-sort] aligned map, fp32: {len(kf)} keyframes, "
          f"{len(qs)} queries x 3; K1 launches {k1_launches} (2 per "
          f"extraction: {2 * extractions}), K2 launches {k2_launches}")
    check(k2_launches == 0, f"[device-sort] K2 launched {k2_launches} times")
    check(k1_launches == 2 * extractions,
          f"[device-sort] K1 launched {k1_launches} times")
    d_def = default.bank.data.cpu().numpy()
    d_srt = dsorted.bank.data.cpu().numpy()
    derr = float(np.abs(d_srt - d_def).max())
    desc_ok = bool(np.allclose(d_srt, d_def, rtol=DSORT_DESC_TOL,
                               atol=DSORT_DESC_TOL))
    worst_t = worst_r = 0.0
    for i, (a, b) in enumerate(zip(results["device sort"],
                                   results["default"])):
        check(a.success == b.success and a.db_index == b.db_index,
              f"[device-sort] call {i}: db {a.db_index} vs {b.db_index}")
        e_t, e_r = (float(e) for e in registration_errors(a.pose, b.pose))
        worst_t, worst_r = max(worst_t, e_t), max(worst_r, e_r)
    print(f"[device-sort] keyframe descriptors max |diff| {derr:.3e} "
          f"(bound rtol = atol = {DSORT_DESC_TOL}); every call the same "
          f"keyframe and success; poses within {worst_t:.4f} m / "
          f"{worst_r:.4f} deg of the default's")
    check(desc_ok, f"[device-sort] descriptors differ by {derr:.3e}")
    check_aligned(torch, "device-sort", results["device sort"][:len(qs)],
                  kf_set, q_set)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[device-sort] locate on {card}, fp32, host clock, median of "
          f"{len(qs)} x 3 (interleaved): default {med['default']:.3f} ms, "
          f"device sort {med['device sort']:.3f} ms")
    rec.update(k1_launches=k1_launches, k2_launches=k2_launches,
               descriptor_err=derr, locate_ms_fp32=med)

    # 3. K1 against its plain version at the launches of this path
    for label, b in (("one scan", 1), ("batch 16", 16)):
        pts = torch.from_numpy(np.stack([s[0] for s in kf[:b]])).cuda()
        mask = torch.from_numpy(np.stack([s[1] for s in kf[:b]])).cuda()
        with torch.no_grad():
            aligned, _ = default._align(pts, mask)
            st = binning_stages(torch, default, dsorted, aligned, mask)
            k1_cases[f"features C=64, {label}"] = record_launches(
                st["K1 features (wrapper)"])["K1"][0][:2]
            ms = {}
            for name in list(st) * 2:  # each twice, the stages alternating
                ms.setdefault(name, []).append(cuda_ms(torch, st[name], 20))
            syncs = {name: count_syncs(torch, st[name]) for name in st}
            traced = {name: device_idle_share(torch, st[name])[:3]
                      for name in list(st)[:2]}
        for name in st:
            print(f"[device-sort] {label}, {name}: "
                  f"{min(ms[name]):.4f}-{max(ms[name]):.4f} ms (CUDA events, "
                  f"mean of 20, L2-warm, twice), host syncs {syncs[name]}")
        for name, (busy, wall, n_k) in traced.items():
            print(f"[device-sort] {label}, {name}, one traced call: device "
                  f"busy {busy:.4f} ms of {wall:.4f} ms wall, {n_k} "
                  f"kernels")
        rec[f"binning_{label.replace(' ', '_')}"] = {
            name: {"ms": ms[name], "host_syncs": syncs[name],
                   "traced_busy_wall_kernels": traced.get(name)}
            for name in st}
    worst = 0.0
    for label, (x, starts) in k1_cases.items():
        rel, err = check_k1(torch, label, x, starts)
        print(f"[device-sort] K1 {label} {tuple(x.shape)}: max |kernel - "
              f"plain| {err:.3e}, relative to per-segment L1 mass "
              f"{rel:.3e} (bound 1e-5)")
        worst = max(worst, rel)
    check(worst < 1e-5, f"[device-sort] K1 disagrees: {worst:.3e}")
    rec["k1_rel_err"] = worst

    # 4. the serving model (bf16): locate both ways, the gates
    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    maps = {"default": build_map(torch, cfg, model, kf, align_ground=True),
            "device sort": build_map(torch, cfg, model, kf,
                                     align_ground=True, device_sort=True)}
    times = {k: [] for k in maps}
    for rep in range(3):
        for q in qs:
            for key, loc in maps.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = loc.locate(*q)
                times[key].append((time.perf_counter() - t0) * 1e3)
                if rep == 0 and key == "device sort":
                    results.setdefault("bf16", []).append(res)
    check_aligned(torch, "device-sort bf16", results["bf16"], kf_set, q_set)
    med = {k: float(np.median(v)) for k, v in times.items()}
    syncs = {k: count_syncs(torch, lambda: loc.locate(*qs[0]))
             for k, loc in maps.items()}
    print(f"[device-sort] locate on {card}, bf16 serving model, host clock, "
          f"median of {len(qs)} x 3 (interleaved): default "
          f"{med['default']:.3f} ms, device sort {med['device sort']:.3f} "
          f"ms; host syncs per locate {syncs}")
    rec.update(locate_ms_bf16=med, locate_syncs=syncs)
    return k1_launches, rec


def serving_localizer(torch, cfg, model, kf, device="cuda", **kw):
    """The serving configuration: the fast_match(fm=True) matcher and the
    device keyframe store without a host mirror, its map built from ``kf``
    in batches of 4."""
    return build_map(torch, cfg.fast_match(fm=True), model, kf, device,
                     device_keyframes=True, host_mirror=False, **kw)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def fused_results(loc, qs, tag):
    """locate_fused on every query; where one does not localize, its BEV
    and its top candidates' BEVs (from the device store) go to
    smoke_out/ (git-ignored) for a look at the matcher there, before the
    gate fails."""
    results = [loc.locate_fused(*q) for q in qs]
    for i, (res, q) in enumerate(zip(results, qs)):
        if res.success:
            continue
        _, bev, _ = loc.extract(q[0][None], q[1][None])
        images, origins = loc._candidates(res.candidates[:3])
        out = os.path.join(REPO, "smoke_out")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"fused_{tag}_query{i}.npz")
        np.savez(path, query=_host(bev.image[0]),
                 query_origin=_host(bev.origin_xy[0]),
                 candidates=res.candidates, images=_host(images),
                 origins=_host(origins))
        print(f"[fused] {tag} query {i} failed: BEVs written to "
              f"{os.path.relpath(path, REPO)}")
    return results


def same_results(tag, a, b, xy_tol=1e-4):
    """Two runs of the same queries: success and keyframe equal, the same
    candidates in the same order, (dx, dy, yaw) within xy_tol. Returns the
    largest (dx, dy, yaw) difference."""
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        same = np.array_equal(x.candidates, y.candidates)
        check(x.success == y.success and x.db_index == y.db_index and same,
              f"{tag} query {i}: success {x.success}/{y.success}, db "
              f"{x.db_index}/{y.db_index}, candidates {x.candidates} / "
              f"{y.candidates}")
        if x.success:
            d = float(np.abs(x.match_xy_yaw - y.match_xy_yaw).max())
            worst = max(worst, d)
            check(d <= xy_tol, f"{tag} query {i}: xy_yaw differs by {d:.3e}")
    return worst


def phase_fused_query(torch, cfg, lq_set, kf_set, q_set, centroids):
    """The serving path (fast_match(fm=True), the device store without a
    host mirror, locate_fused) at full width on both fused variants, held
    to the gates of the located-query phases; then locate, locate_batch and
    locate_fused held to one another. Returns the K1 and K2 launches of the
    two fused runs."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    (kf_poses, kf), (q_poses, qs) = lq_set
    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    reset_launches(ss.segment_sum_sorted)
    loc = serving_localizer(torch, cfg, model, kf, host_stats=True)
    results = fused_results(loc, qs, "host-stats")
    k1 = launches_of(ss.segment_sum_sorted)
    print(f"[fused] host-stats locate_fused, fm preset, device store (no "
          f"host mirror): K1 launches {k1}; store {tuple(loc._kf_store.shape)}"
          f" uint8, {loc._kf_store.numel() / 2**20:.1f} MiB")
    check(k1 >= N_KEYFRAMES // 4 + N_QUERIES, f"K1 launched {k1} times")
    check(all(k.image is None for k in loc.keyframes),
          "host_mirror=False kept images on the host")
    check_located("fused", results, kf_poses, q_poses, cfg.index.top_k)

    reset_launches(bs.pillar_bin_sums)
    a_loc = serving_localizer(torch, cfg, model, kf_set[2], align_ground=True)
    a_results = fused_results(a_loc, q_set[2], "aligned")
    k2 = launches_of(bs.pillar_bin_sums)
    need = 2 * (len(kf_set[2]) // 4 + len(q_set[2]))
    print(f"[fused] aligned all-device locate_fused: K2 launches {k2} (at "
          f"least {need})")
    check(k2 >= need, f"K2 launched {k2} times, < {need}")
    check_aligned(torch, "fused-aligned", a_results, kf_set, q_set)

    # locate = locate_batch = locate_fused on one map, with the fp32 model
    # (a batch of 8 may take other GEMM kernels than a batch of 1, and bf16
    # rounding then reorders keyframes whose descriptors nearly tie)
    loc32 = serving_localizer(torch, cfg, build_serving_model(
        torch, cfg, "float32", centroids), kf, host_stats=True)
    r_loc = [loc32.locate(*q) for q in qs]
    r_batch = loc32.locate_batch(np.stack([q[0] for q in qs]),
                                 np.stack([q[1] for q in qs]))
    r_fused = [loc32.locate_fused(*q) for q in qs]
    d1 = same_results("locate vs locate_batch", r_loc, r_batch)
    d2 = same_results("locate vs locate_fused", r_loc, r_fused)
    # the aligned map: locate and locate_fused each extract the query with
    # the same ground draws and must agree ranks and all (K2 sums every
    # pillar in a fixed order); a third extraction with those draws must
    # swap no candidate rank
    d3, swaps = 0.0, 0
    for i, q in enumerate(q_set[2]):
        a_loc._gen.manual_seed(100 + i)
        x = a_loc.locate(*q)
        a_loc._gen.manual_seed(100 + i)
        y = a_loc.locate_fused(*q)
        d = same_results("aligned locate vs locate_fused", [x], [y])
        d3 = max(d3, d)
        a_loc._gen.manual_seed(100 + i)
        swaps += int((a_loc.locate_fused(*q).candidates != y.candidates).sum())
    print(f"[fused] fp32 host-stats map: locate = locate_batch = "
          f"locate_fused for {len(qs)}/{len(qs)} queries "
          f"({sum(r.success for r in r_loc)} localized); xy_yaw max |diff| "
          f"{d1:.2e} / {d2:.2e}; aligned bf16 map: locate = locate_fused, "
          f"each on its own extraction, max |diff| {d3:.2e} (bound 1e-4); "
          f"a third extraction with the same draws swapped {swaps} of "
          f"{len(q_set[2]) * cfg.index.top_k} candidate ranks (must be 0)")
    check(swaps == 0, f"[fused] a repeated aligned extraction swapped "
          f"{swaps} candidate ranks")
    return k1, k2


def count_syncs(torch, fn) -> int:
    """Host synchronisations of one call of fn(), as
    torch.cuda.set_sync_debug_mode("warn") reports them (not counting the
    mode's own once-per-process notice that it is a prototype)."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in caught)


def phase_fused_cell(torch, cfg, centroids, card):
    """bench.py's fused cells: a 10 000-row bank of random rows with the
    real descriptor planted at row 5 000, a 10 000-row device store holding
    its BEV there, fold_bn=True and the fm preset, bench.py's synthetic
    query scan; host stats and aligned all-device."""
    from gloc3d_tpu_torch.core.transforms import Rigid3
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer, Keyframe

    n_map, jrow = 10000, 5000
    n = cfg.voxel.max_points
    fcfg = cfg.replace(index=cfg.index.replace(capacity=n_map)).fast_match(
        fm=True)
    pts, mask = bench_query_scan(n)
    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    rows = np.random.RandomState(0).randn(n_map, cfg.index.dim).astype(
        np.float32)
    dev = torch.device("cuda")
    s = fcfg.bev.image_size
    for label, kw in (("host stats", dict(host_stats=True)),
                      ("aligned all-device", dict(align_ground=True))):
        loc = GlobalLocalizer(fcfg, model, device=dev, device_keyframes=True,
                              host_mirror=False, **kw)
        desc, bev, ground = loc.extract(pts, mask)
        loc.bank.add(rows)
        loc.bank._bank[jrow] = desc[0]
        loc._kf_store = torch.zeros((n_map, s, s // 8), dtype=torch.uint8,
                                    device=dev)
        loc._kf_origins = torch.zeros((n_map, 2), device=dev)
        loc._kf_cap = n_map
        loc._store_keyframes(bev.image[:1], bev.origin_xy[:1], offset=jrow)
        g = None if ground is None else Rigid3(
            _host(ground.transform.rotation[0]),
            _host(ground.transform.translation[0]))
        loc.keyframes = [Keyframe(None, None, g)] * n_map
        t0 = time.perf_counter()
        res = loc.locate_fused(pts[0], mask[0])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        check(res.success and res.db_index == jrow,
              f"{label} fused cell: success {res.success}, db "
              f"{res.db_index} (want {jrow})")

        def fused():
            return loc.locate_fused(pts[0], mask[0])

        def eager():
            return loc._fused_result(*loc._fused_run(pts[0], mask[0], None,
                                                     captured=False))

        def plain():
            return loc.locate(pts[0], mask[0])

        t_e = [host_ms(torch, f, 10) for f in (fused, eager, eager, fused)]
        e_busy, e_wall, e_k, _ = device_idle_share(torch, eager)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        pool = graph_pool_mib(torch, loc)  # drops the graphs
        torch.cuda.reset_peak_memory_stats()
        eager()
        torch.cuda.synchronize()
        e_peak = torch.cuda.max_memory_allocated() / 2**20
        t0 = time.perf_counter()
        fused()  # captured again
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
        print(f"[fused-cell] {label}: locate_fused as captured CUDA graphs: "
              f"first call (capture included) {first_s:.3f} s, a capture "
              f"after dropping the graphs {again_s:.3f} s; ms per query "
              f"(host clock, median of 10, order graph, eager, eager, "
              f"graph) {t_e[0]:.3f} / {t_e[1]:.3f} / {t_e[2]:.3f} / "
              f"{t_e[3]:.3f}; the eager program traced: device busy "
              f"{e_busy:.3f} ms of {e_wall:.3f} ms wall, {e_k} kernels; "
              f"peak allocated with the graphs {peak:.1f} MiB (their pool "
              f"{pool:.1f} MiB more), without them (eager program) "
              f"{e_peak:.1f} MiB; {card}")

        # order fused, locate, locate, fused: the host clock drifts
        t = [host_ms(torch, f, 10) for f in (fused, plain, plain, fused)]
        syncs = (count_syncs(torch, plain), count_syncs(torch, fused))
        busy, wall, n_k, by_class = device_idle_share(torch, fused)
        print(f"[fused-cell] {label}, {n_map}-row bank and store "
              f"({loc._kf_store.numel() / 1e6:.1f} MB), fm preset, bf16, on "
              f"{card}: locate_fused {t[0]:.3f} / {t[3]:.3f} ms per query, "
              f"locate (same map and store) {t[1]:.3f} / {t[2]:.3f} ms (host "
              f"clock, median of 10 each, in the order fused, locate, "
              f"locate, fused; db {res.db_index}, score "
              f"{res.match_score:.3f}); host syncs per call "
              f"(set_sync_debug_mode): locate {syncs[0]}, locate_fused "
              f"{syncs[1]}")
        print(f"[fused-cell] {label}: traced locate_fused, device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
              f"{1 - busy / wall:.3f}, {n_k} kernels (torch.profiler; "
              f"against the untraced {t[0]:.3f} ms the idle share is "
              f"{max(0.0, 1 - busy / t[0]):.3f}); device ms by class: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                  by_class.items(), key=lambda kv: -kv[1])))
        if label != "host stats":
            continue
        flat_ms = (t[0], t[3])
        q_img = torch.as_tensor(bev.image[:1], device=dev)
        q_org = torch.as_tensor(bev.origin_xy[:1], device=dev)
        configs = [(name, mcfg, k) for name, mcfg in (
            ("fm preset", fcfg.match), ("default matcher", cfg.match))
            for k in (1, cfg.index.top_k)]
        times = {c[0::2]: [] for c in configs}
        for order in (configs, configs[::-1]):
            for name, mcfg, k in order:
                loc.cfg = fcfg.replace(match=mcfg)
                idx = torch.full((1, k), jrow, dtype=torch.long,
                                 device=dev)
                times[name, k].append(cuda_ms(
                    torch, lambda: loc._match(q_img, q_org, idx), 20))
        parts = []
        for name, mcfg, k in configs:
            loc.cfg = fcfg.replace(match=mcfg)
            idx = torch.full((1, k), jrow, dtype=torch.long, device=dev)
            busy, _, n_k, _ = device_idle_share(
                torch, lambda: loc._match(q_img, q_org, idx))
            a, b = times[name, k]
            parts.append(f"{name} K={k} {a:.3f} / {b:.3f} ms (device busy "
                         f"{busy:.3f} ms, {n_k} kernels)")
        loc.cfg = fcfg
        print(f"[fused-cell] registration on {card} (CUDA events around the "
              f"store gather + match, mean of 20, query image on the device, "
              f"in one order and then the reverse; device busy from one "
              f"torch.profiler trace): " + "; ".join(parts))
    return flat_ms


def phase_fused_reference(torch, cfg, lq_set, centroids,
                          devices=("cuda", "cpu")):
    """One fm-preset locate_fused query on the card against the same port
    code on the CPU, fp32 with TF32 off: same success and keyframe, (dx,
    dy) within one fine cell (0.4 m at fine_downsample=2), yaw within one
    fine bin."""
    (_, kf), (_, qs) = lq_set
    out = {}
    for dev in devices:
        model = build_serving_model(torch, cfg, "float32", centroids)
        loc = serving_localizer(torch, cfg, model, kf[:2], device=dev,
                                host_stats=True)
        out[dev] = loc.locate_fused(*qs[0])
    a, b = (out[d] for d in devices)
    mcfg = cfg.fast_match(fm=True).match
    cell = cfg.bev.resolution * mcfg.fine_downsample
    fine_bin = math.radians(mcfg.refine_span_deg
                            / (mcfg.refine_rotations - 1))
    print(f"[fused-reference] fm preset, card vs CPU: success "
          f"{a.success}/{b.success}, db {a.db_index}/{b.db_index}")
    check(a.success == b.success and a.db_index == b.db_index,
          "card locate_fused != CPU locate_fused")
    if a.success:
        dxy = float(np.abs(a.match_xy_yaw[:2] - b.match_xy_yaw[:2]).max())
        dyaw = abs(math.remainder(float(a.match_xy_yaw[2]
                                        - b.match_xy_yaw[2]), 2 * math.pi))
        print(f"[fused-reference] (dx, dy) max |diff| {dxy:.2e} m (bound "
              f"{cell} m), yaw |diff| {math.degrees(dyaw):.2e} deg (bound "
              f"{math.degrees(fine_bin):.2f} deg)")
        check(dxy <= cell + 1e-3 and dyaw <= fine_bin + 1e-4,
              "card pose disagrees with the CPU pose")


# ---------------------------------------------------------------- [fused-graph]
FUSED_IVF = dict(backend="ivf", ivf_num_cells=4, ivf_nprobe=4,
                 ivf_cell_capacity=8, ivf_train_sample=64)
FUSED_BANKS = {"flat fp32": {}, "flat int8": {"quantize": "int8"},
               "IVF fp32": FUSED_IVF,
               "IVF int8": dict(FUSED_IVF, quantize="int8")}
FUSED_VARIANTS = (  # (variant, map, localizer switches)
    ("host stats", "located", dict(host_stats=True)),
    ("host stats, aligned", "aligned", dict(host_stats=True,
                                            align_ground=True)),
    ("all-device", "located", {}),
    ("aligned", "aligned", dict(align_ground=True)),
    ("device_sort", "located", dict(device_sort=True)),
    ("images", "images", {}))
FUSED_FAR = (80.0, 80.0, 0.0)  # no keyframe sees it: stage 1 fails
FUSED_TIMED = 3                # host-clock calls per timing


def same_bits(a: dict, b: dict) -> bool:
    """Two unpacked fused results hold the same bytes under every name."""
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).shape == np.asarray(b[k]).shape
        and np.array_equal(np.asarray(a[k]).view(np.uint8),
                           np.asarray(b[k]).view(np.uint8)) for k in a)


def fused_graph_sets(torch, cfg, world, lq_set, kf_set, q_set):
    """Per map: (keyframe batches as add_keyframes takes them, queries as
    locate_fused takes them; two of the map's queries and one far from
    every keyframe, last)."""
    from gloc3d_tpu_torch import PipelineConfig

    n = cfg.voxel.max_points
    far = scan_at(world, FUSED_FAR, n, seed=300)
    icfg = PipelineConfig.i2i()

    def scans(kf):
        return [(np.stack([k[0] for k in kf[i:i + 4]]),
                 np.stack([k[1] for k in kf[i:i + 4]]))
                for i in range(0, len(kf), 4)]

    kf_img, kf_org = render_bevs(torch, icfg, lq_set[0][1])
    q_img, q_org = render_bevs(torch, icfg, lq_set[1][1][:2] + [far])
    return {
        "located": (scans(lq_set[0][1]), lq_set[1][1][:2] + [far]),
        "aligned": (scans(kf_set[2]), q_set[2][:2] + [far]),
        "images": ([(kf_img[i:i + 4], None, kf_org[i:i + 4])
                    for i in range(0, len(kf_img), 4)],
                   [(q_img[i], None, q_org[i]) for i in range(3)])}


def swap_bank(loc, index, rows) -> None:
    """Give ``loc`` a new bank of the configuration ``index`` holding
    ``rows`` (the map's descriptors), as the localizer builds it."""
    from gloc3d_tpu_torch.index.bank import DescriptorBank
    from gloc3d_tpu_torch.pipeline import _IVFBankAdapter

    loc.cfg = loc.cfg.replace(index=index)
    loc.bank = (_IVFBankAdapter(index, index.dim, loc.device)
                if index.backend == "ivf"
                else DescriptorBank(index, dim=index.dim, device=loc.device))
    loc.bank.add(rows)


def strict_launches(torch, graphs) -> None:
    """Run a captured program's staging and replays under
    set_sync_debug_mode("error"): any synchronisation there raises."""
    def strict(fn):
        def run(*args):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return run

    graphs.launch = strict(graphs.launch)
    graphs.launch_full = strict(graphs.launch_full)


def fused_graph_case(torch, loc, queries, variant, captures,
                     eager_trace: bool) -> dict:
    """One variant on one bank: the first call (capture), then for each
    query the replayed programs against the eager ones bit for bit and
    against locate, host syncs per call, the K2 status raised after the
    fetch; timings, traces and peak memory on the first query."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import knn_normals as kn
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    reset_launches(ss.segment_sum_sorted, bs.pillar_bin_sums, kn.knn_normals)

    def seeded(i):
        if loc.align_ground:  # the same ground draws on every path
            loc._gen.manual_seed(1000 + i)

    def fused(i=0):
        seeded(i)
        return loc.locate_fused(*queries[i])

    def eager(i=0):
        seeded(i)
        return loc._fused_result(*loc._fused_run(*queries[i],
                                                 captured=False))

    def plain(i=0):
        seeded(i)
        return loc.locate(*queries[i])

    n_cap = len(captures)
    t0 = time.perf_counter()
    fused()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(len(captures) == n_cap + 1, f"[fused-graph] {variant}: the first "
          f"call made {len(captures) - n_cap} captures")
    strict_launches(torch, loc._fused_graphs)
    rec = {"capture_s": captures[-1], "first_call_s": first_s,
           "bit_equal": True, "stage2": [], "syncs": []}
    worst = 0.0
    for i in range(len(queries)):
        seeded(i)
        g = loc._fused_run(*queries[i])
        seeded(i)
        e = loc._fused_run(*queries[i], captured=False)
        same = same_bits(g[0], e[0]) and (g[1] is None) == (e[1] is None) \
            and (g[1] is None or same_bits(g[1], e[1]))
        rec["bit_equal"] = rec["bit_equal"] and same
        check(same, f"[fused-graph] {variant} query {i}: the replayed "
              f"result differs from the eager program's")
        worst = max(worst, same_results(
            f"[fused-graph] {variant} locate vs locate_fused",
            [plain(i)], [loc._fused_result(*g)]))
        rec["stage2"].append(g[1] is not None)
        rec["syncs"].append(count_syncs(torch, lambda: fused(i)))
        want = 1 + (g[1] is not None) + (variant == "host stats, aligned")
        check(rec["syncs"][-1] == want, f"[fused-graph] {variant} query "
              f"{i}: {rec['syncs'][-1]} host syncs per call, want {want}")
    check(rec["stage2"][-1], f"[fused-graph] {variant}: the far query did "
          f"not take stage 2")
    check(len(captures) == n_cap + 1, f"[fused-graph] {variant}: "
          f"recaptured on an unchanged map")
    rec["locate_max_diff"] = worst
    # the k-NN normals: one launch a query where the localizer aligns (in
    # the replayed graph, or the host-stats variant's own alignment)
    n_knn = launches_of(kn.knn_normals)
    fused()
    torch.cuda.synchronize()
    rec["knn_per_query"] = launches_of(kn.knn_normals) - n_knn
    check(rec["knn_per_query"] == int(loc.align_ground), f"[fused-graph] "
          f"{variant}: {rec['knn_per_query']} k-NN normals launches a "
          f"query, want {int(loc.align_ground)}")

    def host_side():  # the host pass (and its alignment), before the upload
        seeded(0)
        return loc._fused_query(loc._fused_variant(queries[0][0]),
                                *queries[0])

    rec["ms"] = [host_ms(torch, f, FUSED_TIMED)
                 for f in (fused, eager, eager, fused)]
    rec["host_side_ms"] = host_ms(torch, host_side, FUSED_TIMED)
    rec["locate_ms"] = host_ms(torch, plain, FUSED_TIMED)
    for name, fn in (("", fused), ("eager_", eager))[:1 + eager_trace]:
        busy, wall, n_k, _ = device_idle_share(torch, fn)
        rec[name + "busy_ms"], rec[name + "wall_ms"] = busy, wall
        rec[name + "kernels"] = n_k
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        rec[name + "peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    rec["graph_pool_mib"] = graph_pool_mib(torch, loc)
    rec["replayed"] = (ss.segment_sum_sorted.replayed,
                       bs.pillar_bin_sums.replayed, kn.knn_normals.replayed)
    rec["launches"] = (launches_of(ss.segment_sum_sorted),
                       launches_of(bs.pillar_bin_sums),
                       launches_of(kn.knn_normals))
    return rec


def graph_pool_mib(torch, loc) -> float:
    """Device memory the localizer's captured graphs hold (their pool):
    the reserved memory that goes when they are dropped."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    loc._fused_graphs = None
    gc.collect()  # strict_launches' wrappers hold the graphs in a cycle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (held - torch.cuda.memory_reserved()) / 2**20


def fused_status_fault(torch, loc, query) -> str:
    """A K2 status word set to one bad id in the captured program's result
    before the fetch: locate_fused must raise the kernel's error."""
    loc.locate_fused(*query)  # captured on this bank
    graphs = loc._fused_graphs
    at = 0
    for name, shape, _ in graphs.layout:
        if name == "k2_status0":
            break
        at += int(np.prod(shape))
    fetch = graphs.fetch

    def faulty():
        graphs.words[at] = 1
        return fetch()

    graphs.fetch = faulty
    try:
        loc.locate_fused(*query)
    except ValueError as e:
        return str(e)
    finally:
        graphs.fetch = fetch
    raise SmokeFailure("[fused-graph] a bad K2 status in the captured "
                       "program's result did not raise")


# a fresh process (a failed capture leaves torch's allocator deferring
# frees for good): a host read planted in the fused program's stage 1
FUSED_CAPTURE_FAILURE = textwrap.dedent("""
    import numpy as np
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer, Keyframe

    cfg = PipelineConfig.s2s()
    loc = GlobalLocalizer(cfg, init_params(build_model(cfg.model, cfg.voxel),
                                           seed=0),
                          device="cuda", device_keyframes=True,
                          host_mirror=False)
    rng = np.random.RandomState(0)
    s, n = cfg.bev.image_size, cfg.voxel.max_points
    loc.bank.add(rng.randn(4, cfg.index.dim).astype(np.float32))
    loc._store_keyframes((rng.rand(4, s, s) < 0.5).astype(np.float32),
                         rng.randn(4, 2).astype(np.float32), offset=0)
    loc.keyframes = [Keyframe(None, None)] * 4
    match = loc._fused_match

    def planted(q_image, q_origin, rows, store):
        float(rows.sum())
        return match(q_image, q_origin, rows, store)

    loc._fused_match = planted
    try:
        loc.locate_fused(rng.uniform(-30, 30, (n, 4)).astype(np.float32),
                         np.ones(n, np.float32))
    except Exception as e:  # the capture's own error, whatever its type
        print(type(e).__name__ + ": " + str(e).splitlines()[0][:100])
    else:
        raise SystemExit("locate_fused answered with a host read planted")
""")


def fused_capture_failure() -> str:
    """A host read planted in the program (``float()`` of a device value in
    stage 1's registration), in a fresh process: the capture must fail and
    locate_fused raise, with no answer from an eager run."""
    r = subprocess.run([sys.executable, "-c", FUSED_CAPTURE_FAILURE],
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    check(r.returncode == 0 and r.stdout.strip(), f"[fused-graph] the "
          f"planted host read: rc {r.returncode}, {r.stdout[-500:]} "
          f"{r.stderr[-2000:]}")
    return r.stdout.strip().splitlines()[-1]


def fused_add_after_capture(torch, loc, query, captures) -> dict:
    """A keyframe added after a capture, the first query's own scan: the
    next locate_fused must return it (the sizes are device inputs)."""
    loc.locate_fused(*query)
    n_cap, n_kf = len(captures), len(loc.keyframes)
    if np.ndim(query[0]) == 3:
        loc.add_keyframes(query[0][None], origins=query[2][None])
    else:
        loc.add_keyframes(query[0][None], query[1][None])
    res = loc.locate_fused(*query)
    check(res.success and res.db_index == n_kf, f"[fused-graph] the "
          f"keyframe added after a capture did not come back: {res}")
    return {"db_index": res.db_index, "recaptures": len(captures) - n_cap}


def phase_fused_graph(torch, cfg, world, centroids, lq_set, kf_set, q_set,
                      card) -> dict:
    """[fused-graph]: locate_fused as two captured CUDA graphs on every
    extraction variant and bank, fp32 with TF32 off, the fm preset."""
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch import pipeline

    sets = fused_graph_sets(torch, cfg, world, lq_set, kf_set, q_set)
    captures = []
    capture = pipeline._FusedGraphs.__init__

    def timed_capture(self, *args):
        t0 = time.perf_counter()
        capture(self, *args)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t0)

    pipeline._FusedGraphs.__init__ = timed_capture
    out = {}
    try:
        for variant, kind, kw in FUSED_VARIANTS:
            if kind == "images":
                vcfg = PipelineConfig.i2i().fast_match(fm=True)
                model = i2i_model(torch, vcfg, "float32",
                                  i2i_centroids(torch, vcfg, kf_set))
            else:
                vcfg = cfg.fast_match(fm=True)
                model = build_serving_model(torch, cfg, "float32",
                                            centroids)
            loc = pipeline.GlobalLocalizer(
                vcfg, model, device=torch.device("cuda"),
                device_keyframes=True, host_mirror=False, **kw)
            batches, queries = sets[kind]
            for b in batches:
                loc.add_keyframes(*b)
            rows = loc.bank.data.clone()
            out[variant] = {}
            for bank, over in FUSED_BANKS.items():
                swap_bank(loc, vcfg.index.replace(**over), rows)
                rec = fused_graph_case(torch, loc, queries, variant,
                                       captures, bank == "flat fp32")
                out[variant][bank] = rec
                print(f"[fused-graph] {variant}, {bank} bank, "
                      f"{len(batches) * 4} keyframes, fp32, on {card}: "
                      f"capture {rec['capture_s']:.3f} s (first call "
                      f"{rec['first_call_s']:.3f} s); replay = eager program "
                      f"bit for bit on {len(queries)} queries (stage 2 on "
                      f"{sum(rec['stage2'])}), = locate (xy_yaw max |diff| "
                      f"{rec['locate_max_diff']:.2e}); host syncs per call "
                      f"{rec['syncs']}; ms per query (host clock, median of "
                      f"{FUSED_TIMED}, order graph, eager, eager, graph) "
                      + " / ".join(f"{t:.3f}" for t in rec["ms"])
                      + f", locate {rec['locate_ms']:.3f}; traced: graph "
                      f"busy {rec['busy_ms']:.3f} of {rec['wall_ms']:.3f} ms "
                      f"wall, {rec['kernels']} kernels"
                      + ("" if "eager_kernels" not in rec else
                         f"; eager busy {rec['eager_busy_ms']:.3f} of "
                         f"{rec['eager_wall_ms']:.3f} ms, "
                         f"{rec['eager_kernels']} kernels, peak allocated "
                         f"{rec['eager_peak_mib']:.1f} MiB")
                      + f"; the host side before the upload "
                      f"{rec['host_side_ms']:.3f} ms; peak allocated "
                      f"{rec['peak_mib']:.1f} MiB, the graphs' pool "
                      f"{rec['graph_pool_mib']:.1f} MiB; K1 / K2 / k-NN "
                      f"normals launches "
                      f"{rec['launches']} (in replays {rec['replayed']}; "
                      f"k-NN a query {rec['knn_per_query']})")
            if variant in ("all-device", "aligned"):
                msg = fused_status_fault(torch, loc, queries[0])
                out[variant]["status_fault"] = msg[:120]
                print(f"[fused-graph] {variant}: a bad K2 status in the "
                      f"replay's result raises after the fetch: {msg[:120]}")
            if variant == "host stats":
                msg = fused_capture_failure()
                out[variant]["capture_failure"] = msg
                print(f"[fused-graph] {variant}: a host read planted in the "
                      f"program fails the capture and locate_fused raises "
                      f"({msg})")
            if variant in ("host stats", "all-device"):
                calls = record_launches(
                    lambda: loc._fused_run(*queries[0], captured=False))
                errs = []
                for key, launches in calls.items():
                    for args in launches:
                        rel = check_recorded(
                            torch, f"[fused-graph] {variant} {key}", key,
                            args)
                        errs.append(f"{key} {rel:.2e}")
                check(errs, f"[fused-graph] {variant}: no kernel launch")
                print(f"[fused-graph] {variant}: every kernel launch of the "
                      f"eager program, which the replays equal bit for bit, "
                      f"against its plain version (1e-5 of L1 mass): "
                      + ", ".join(errs))
            swap_bank(loc, vcfg.index, rows)
            out[variant]["add"] = fused_add_after_capture(
                torch, loc, queries[0], captures)
            print(f"[fused-graph] {variant}: a keyframe added after the "
                  f"capture comes back (db {out[variant]['add']['db_index']}"
                  f"; recaptures {out[variant]['add']['recaptures']})")
            del loc, model
            torch.cuda.empty_cache()
    finally:
        pipeline._FusedGraphs.__init__ = capture
    return out


# ---------------------------------------------------------------- [batched]
BATCH_GROUND = 16  # aligned scans in one batched ground call
GROUND_TOL = 1e-6  # batched ground transforms against the B = 1 calls


def stacked(scans):
    """(points (B, N, 4), masks (B, N)) of a list of (points, mask)."""
    return (np.stack([s[0] for s in scans]), np.stack([s[1] for s in scans]))


def registration_results(loc, detected, batched: bool):
    """locate_batch's registration on one extraction of the batch
    (``detected``, what ``loc.detect`` returned): one ``_register`` call
    over the batch, or one ``_staged`` call per query (locate's). The
    LocalizationResults of each."""
    from gloc3d_tpu_torch.ops.bev_match import MatchResult

    d2, idx, bev, ground = detected
    idx = np.clip(idx, 0, len(loc.keyframes) - 1)
    if batched:
        res = loc._register(bev.image, bev.origin_xy, idx)
        lanes = [MatchResult(*(x[q] for x in res)) for q in range(len(idx))]
    else:
        lanes = [loc._staged(bev.image[q], bev.origin_xy[q], idx[q])
                 for q in range(len(idx))]
    return [loc._result(lane, idx[q], d2[q], ground, q)
            for q, lane in enumerate(lanes)]


def entry_point_results(loc, qs, seed: int):
    """locate_batch of the queries and one locate per query, each starting
    the localizer's generator from ``seed`` (an aligned map then draws the
    same ground samples for each scan in both)."""
    pts, masks = stacked(qs)
    loc._gen.manual_seed(seed)
    batch = loc.locate_batch(pts, masks)
    loc._gen.manual_seed(seed)
    return batch, [loc.locate(*q) for q in qs]


def batched_ground(torch, loc, scans, card):
    """The batched ground estimate of ``scans`` against one B = 1 call per
    scan on the same draws: same ``valid``, transforms within GROUND_TOL;
    the time per scan and the kernels of each."""
    pts, masks = stacked(scans)
    p_d = torch.from_numpy(pts).cuda()
    m_d = torch.from_numpy(masks).cuda()
    b = len(scans)

    def batch():
        loc._gen.manual_seed(1234)
        return loc._align(p_d, m_d)[1]

    def single():
        loc._gen.manual_seed(1234)
        return [loc._align(p_d[i:i + 1], m_d[i:i + 1])[1] for i in range(b)]

    with torch.no_grad():
        got, want = batch(), single()
        valid = [bool(w.valid[0]) for w in want]
        check([bool(v) for v in got.valid.cpu()] == valid,
              f"[batched] ground valid {got.valid.tolist()} / {valid}")
        err = max(float((getattr(got.transform, f)[i]
                         - getattr(w.transform, f)[0]).abs().max())
                  for i, w in enumerate(want)
                  for f in ("rotation", "translation"))
        check(err <= GROUND_TOL, f"[batched] batched ground transforms "
              f"differ from the B = 1 calls by {err:.3e}")
        t = [host_ms(torch, f, 5) / b for f in (batch, single, single, batch)]
        n_batch = device_idle_share(torch, batch)[2]
        n_single = device_idle_share(torch, single)[2]
    print(f"[batched] ground: {b} aligned scans in one estimate_ground_batch"
          f" call = {b} B = 1 calls ({sum(valid)} valid in both; rotation and"
          f" translation max |diff| {err:.3e}, bound {GROUND_TOL}); on "
          f"{card}: {t[0]:.3f} / {t[3]:.3f} ms per scan batched, "
          f"{t[1]:.3f} / {t[2]:.3f} ms per scan one call each (host clock "
          f"around a CUDA sync, median of 5, in the order batch, single, "
          f"single, batch; the draws and the rotation included); kernels "
          f"(torch.profiler) {n_batch} for the batch, {n_single} for the "
          f"{b} calls")
    return dict(scans=b, max_diff=err, ms_per_scan_batch=[t[0], t[3]],
                ms_per_scan_single=[t[1], t[2]], kernels_batch=n_batch,
                kernels_single=n_single)


def extraction_spread(torch, loc, qs, seed: int):
    """The batch's extraction against one extraction per query on the same
    draws: the largest descriptor difference and the candidate ranks that
    differ (bf16 convolutions may round a batch of 8 and a batch of 1
    apart)."""
    pts, masks = stacked(qs)
    with torch.no_grad():
        loc._gen.manual_seed(seed)
        desc, _, _ = loc.extract(pts, masks)
        d_b, i_b = loc.bank.query(desc, k=loc.cfg.index.top_k)
        loc._gen.manual_seed(seed)
        ones = [loc.extract(q[0][None], q[1][None])[0] for q in qs]
    i_s = np.concatenate([loc.bank.query(d, k=loc.cfg.index.top_k)[1]
                          for d in ones])
    diff = float((desc.float() - torch.cat(ones).float()).abs().max())
    return diff, int((np.asarray(i_b) != i_s).sum())


def batched_map(torch, cfg, tag, loc, loc32, qs, card):
    """[batched] on one map: the registration of locate_batch held to
    locate's on one extraction (bf16), the entry points held to each other
    (fp32: in bf16 the batch of 8 and the batch of 1 may round the
    descriptors apart and reorder near-tied candidates, as phases 9 and 23
    found), and per-query times, kernels and host syncs of both (bf16)."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import knn_normals as kn
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    b = len(qs)
    pts, masks = stacked(qs)
    with torch.no_grad():
        detected = loc.detect(pts, masks)
        d_reg = same_results(f"[batched] {tag} registration, batch vs one "
                             "query", registration_results(loc, detected,
                                                           True),
                             registration_results(loc, detected, False))
    batch, single = entry_point_results(loc32, qs, seed=77)
    d_entry = same_results(f"[batched] {tag} fp32 locate_batch vs locate",
                           batch, single)
    d_desc, swaps = extraction_spread(torch, loc, qs, seed=77)

    def run_batch():
        return loc.locate_batch(pts, masks)

    def run_single():
        return [loc.locate(*q) for q in qs]

    t = [host_ms(torch, f, 5) / b
         for f in (run_batch, run_single, run_single, run_batch)]
    reset_launches(ss.segment_sum_sorted, bs.pillar_bin_sums, kn.knn_normals)
    run_batch()
    k12 = (launches_of(ss.segment_sum_sorted),
           launches_of(bs.pillar_bin_sums))
    knn = launches_of(kn.knn_normals)
    check(knn == int(loc.align_ground), f"[batched] {tag}: one locate_batch "
          f"launched the k-NN normals {knn} times, want "
          f"{int(loc.align_ground)}")
    n_batch = device_idle_share(torch, run_batch)[2]
    n_single = device_idle_share(torch, run_single)[2]
    with torch.no_grad():
        _, idx, bev, _ = loc.detect(pts, masks)
    idx = np.clip(idx, 0, len(loc.keyframes) - 1)
    reg_batch = device_idle_share(torch, lambda: loc._register(
        bev.image, bev.origin_xy, idx))[2]
    reg_single = device_idle_share(torch, lambda: [loc._staged(
        bev.image[q], bev.origin_xy[q], idx[q]) for q in range(b)])[2]
    syncs = (count_syncs(torch, run_batch), count_syncs(torch, run_single))
    n_ok = sum(r.success for r in batch)
    print(f"[batched] {tag} map, default matcher, staged first: fp32 "
          f"locate_batch of {b} = {b} locate calls (success, keyframe and "
          f"ranked candidates equal, (dx, dy, yaw) max |diff| "
          f"{d_entry:.2e}); bf16: locate_batch's registration = locate's on "
          f"one extraction ({n_ok} localized, max |diff| {d_reg:.2e}); bound "
          f"1e-4. bf16 extraction of the batch against one per query: "
          f"descriptors max |diff| {d_desc:.2e}, {swaps} of "
          f"{b * cfg.index.top_k} candidate ranks differ (not gated)")
    print(f"[batched] {tag} on {card}: locate_batch {t[0]:.3f} / {t[3]:.3f} "
          f"ms per query, locate {t[1]:.3f} / {t[2]:.3f} ms per query (host "
          f"clock around a CUDA sync, median of 5, in the order batch, "
          f"single, single, batch); kernels (torch.profiler) per call: "
          f"locate_batch of {b} {n_batch}, locate {n_single / b:.1f}; "
          f"registration alone: one _register over the batch {reg_batch}, "
          f"{b} _staged calls {reg_single}; host syncs "
          f"(set_sync_debug_mode): locate_batch {syncs[0]}, {b} locate "
          f"calls {syncs[1]}; K1 / K2 / k-NN normals launches of one "
          f"locate_batch {k12[0]} / {k12[1]} / {knn}")
    return dict(queries=b, localized=n_ok, max_diff_entry=d_entry,
                max_diff_registration=d_reg, bf16_desc_diff=d_desc,
                bf16_rank_swaps=swaps, ms_per_query_batch=[t[0], t[3]],
                ms_per_query_single=[t[1], t[2]], kernels_batch=n_batch,
                kernels_single=n_single, kernels_register_batch=reg_batch,
                kernels_staged_single=reg_single, syncs_batch=syncs[0],
                syncs_single=syncs[1], k1_k2_batch=list(k12), knn_batch=knn)


def unstaged_peak(torch, cfg, loc, qs, card):
    """The device memory peak of unstaged locate_batch over the queries at
    K = top_k, the default matcher: the worst case of the evaluator's
    batch, every query registered against all its candidates in one
    call."""
    pts, masks = stacked(qs)
    loc.cfg = cfg.replace(match=cfg.match.replace(staged_first=False))
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loc.locate_batch(pts, masks)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
    finally:
        loc.cfg = cfg
        torch.cuda.empty_cache()
    print(f"[batched] unstaged locate_batch, B = {len(qs)}, K = "
          f"{cfg.index.top_k}, default matcher, on {card}: device memory "
          f"peak {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB "
          f"above the {base / 2**30:.2f} GiB held before; "
          f"torch.cuda.max_memory_allocated), one call {ms:.1f} ms")
    return dict(peak_gib=peak / 2**30, above_gib=(peak - base) / 2**30,
                ms=ms)


def phase_batched(torch, cfg, centroids, lq_set, kf_set, q_set, loc, a_loc,
                  card):
    """[batched]: locate_batch registers each stage in one call over the
    batch and _align estimates every scan's ground in one call. On the
    host-stats map of phase 5 and the aligned map of phase 6 (bf16, full
    width) and their fp32 twins: the entry points and the registration held
    to the one-query calls, the batched ground transforms of BATCH_GROUND
    aligned scans held to the B = 1 calls, times, kernels and host syncs,
    and the memory peak of the worst case."""
    t_phase = time.perf_counter()
    (_, kf), (_, qs) = lq_set
    model32 = build_serving_model(torch, cfg, "float32", centroids)
    loc32 = build_map(torch, cfg, model32, kf, host_stats=True)
    a_loc32 = build_map(torch, cfg, model32, kf_set[2], align_ground=True)
    out = {"host-stats": batched_map(torch, cfg, "host-stats", loc, loc32,
                                     qs, card),
           "aligned": batched_map(torch, cfg, "aligned", a_loc, a_loc32,
                                  q_set[2], card),
           "ground": batched_ground(torch, a_loc,
                                    kf_set[2][:BATCH_GROUND], card),
           "unstaged_peak": unstaged_peak(torch, cfg, loc, qs, card)}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[batched] phase wall time {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- map scale
MAP_N, MAP_DIMS, MAP_K, MAP_ROW = 1_000_000, (128, 512), 20, 123
IVF_CELLS, IVF_CAP, IVF_PROBE, IVF_TRAIN = 1024, 2048, 32, 65536
CITY_N = 100_000
HBM_BYTES_PER_S = 3.35e12


def map_rows(torch, n: int, d: int, seed: int, device: str = "cuda"):
    """tools/bench_bank.py's map: n unit-norm rows from ``seed``, made on
    the device, and 8 queries: row MAP_ROW and 7 other rows, each with
    0.02 Gaussian noise per element (the planted near-duplicates). Returns
    (rows, queries, the rows each query was made from)."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randn((n, d), generator=g, device=device)
    rows /= rows.norm(dim=1, keepdim=True)
    at = torch.tensor([MAP_ROW] + [(n // 8) * i + 7 for i in range(1, 8)],
                      device=device)
    return rows, rows[at] + 0.02 * torch.randn((8, d), generator=g,
                                               device=device), at


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def search_times(torch, dist_fn, sel_fn, n_bytes: int) -> dict:
    """CUDA-event ms of a search's distance pass, its selection on that
    pass's output, and the whole, mean of 20 each; the bound is n_bytes
    over the card's memory rate."""
    out = dist_fn()
    t = {"distance_ms": cuda_ms(torch, dist_fn, 20),
         "select_ms": cuda_ms(torch, lambda: sel_fn(out), 20),
         "search_ms": cuda_ms(torch, lambda: sel_fn(dist_fn()), 20),
         "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
    return t


def phase_map_scale(torch, card, seed: int = 0, device: str = "cuda"):
    """tools/bench_bank.py's settings on the port's four map-scale banks:
    flat fp32, flat int8 (DescriptorBank) and IVF with fp32 and int8 cells
    (IVFBank: IVF_CELLS cells of capacity IVF_CAP, nprobe IVF_PROBE, the
    quantizer trained on IVF_TRAIN rows, 10 Lloyd steps as bench_bank.py
    runs), MAP_N unit-norm rows at each D of MAP_DIMS, top-MAP_K. Prints
    each bank's build time (host clock), device bytes and per-query time at
    Q=1 and Q=8 split into the distance pass and the selection (a stable
    sort of the whole row), beside the bound (bytes read / 3.35 TB/s),
    and the two candidate int8 products (cuBLASLt int8 against an fp32
    product of the int8 values) and torch.topk beside the sort. Checks:
    the planted row at rank 1 everywhere; int8 rank 1 = fp32 rank 1; IVF
    at full probe = the flat search (first D); exclude_after hides ids ≥
    its bound; one IVF query of each cell kind card = CPU on one loaded
    layout, and both flat int8 and IVF files through save / load on the
    card (first D)."""
    summary = {}
    for d in MAP_DIMS:
        summary.update(map_scale_at(torch, card, d, seed,
                                    torch.device(device)))
        torch.cuda.empty_cache()
    return summary


def map_scale_at(torch, card, d: int, seed: int, dev) -> dict:
    """phase_map_scale at one D; its tensors are freed when it returns."""
    from gloc3d_tpu_torch.config import IndexConfig
    from gloc3d_tpu_torch.index.bank import DescriptorBank
    from gloc3d_tpu_torch.index.ivf import IVFBank, select_ids
    from gloc3d_tpu_torch.ops.topk import (
        int8_dots, l2_topk, quantize_rows, select_topk,
    )

    summary = {}
    rows, queries, at = map_rows(torch, MAP_N, d, seed, dev.type)
    host = rows.cpu().numpy()
    banks = {}
    for quant in ("none", "int8"):
        t0 = time.perf_counter()
        b = DescriptorBank(IndexConfig(dim=d, capacity=MAP_N,
                                       top_k=MAP_K, quantize=quant),
                           device=dev)
        b.add(rows)
        torch.cuda.synchronize()
        banks["flat " + quant] = (b, time.perf_counter() - t0)
    t0 = time.perf_counter()
    ivf32 = IVFBank(d, IVF_CELLS, IVF_CAP, IVF_PROBE, device=dev)
    ivf32.train(host[:IVF_TRAIN], torch.Generator().manual_seed(seed),
                iters=10)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    for quant, ivf in (("none", ivf32), ("int8", None)):
        t0 = time.perf_counter()
        if ivf is None:  # the same quantizer: rank 1 held to fp32's
            ivf = IVFBank(d, IVF_CELLS, IVF_CAP, IVF_PROBE,
                          quantize=quant, device=dev)
            ivf.centroids = ivf32.centroids
        ivf.add(host)
        ivf.device_arrays()
        torch.cuda.synchronize()
        banks["IVF " + quant] = (ivf, t_train + time.perf_counter() - t0)
    del rows

    lines, rank1 = [], {}
    for name, (b, build) in banks.items():
        flat = isinstance(b, DescriptorBank)
        if flat:
            held = nbytes(b._bank, getattr(b, "_scales", None),
                          getattr(b, "_bsq", None))
            valid = torch.ones(MAP_N, dtype=torch.bool, device=dev)
        else:
            held = nbytes(b.centroids, *b.device_arrays())
            # one slot of every table: its row, norm, scale and id
            per_slot = nbytes(*(t[0, 0] for t in b.device_arrays()
                                if t is not None))
        idx = b.query_device(queries, MAP_K)[1]
        idx = idx.cpu().numpy()
        rank1[name] = idx[:, 0]
        check(idx[0, 0] == MAP_ROW, f"D={d} {name}: rank 1 is row "
              f"{idx[0, 0]}, not the planted {MAP_ROW}")
        parts = []
        for qn in (1, 8):
            q = queries[:qn]
            if flat:
                n_bytes = held + q.numel() * 4
                t = search_times(
                    torch, lambda: b.distances(q, valid),
                    lambda x: select_topk(x, MAP_K), n_bytes)
            else:
                probe = l2_topk(q, b.centroids, b.nprobe)[1]
                n_cells = len(torch.unique(probe))
                n_bytes = (nbytes(b.centroids, q)
                           + n_cells * b.cell_capacity * per_slot)
                t = search_times(
                    torch, lambda: b.distances(q),
                    lambda x: select_ids(*x, MAP_K), n_bytes)
            parts.append(
                f"Q={qn}: search {t['search_ms']:.4f} ms "
                f"({t['search_ms'] / qn:.4f} per query; distance pass "
                f"{t['distance_ms']:.4f}, selection {t['select_ms']:.4f};"
                f" bound {t['bound_ms']:.4f} ms for "
                f"{n_bytes / 1e6:.1f} MB read)")
            summary[f"D={d} {name} Q={qn}"] = t
        extra = ("" if flat else f"; train {t_train:.2f} s of it, "
                 f"shared by both cell kinds; max cell "
                 f"{int(b._sizes.max())} of {b.cell_capacity}")
        lines.append(f"[map-scale] D={d} {name}: build {build:.2f} s "
                     f"(host clock{extra}), device bytes "
                     f"{held / 1e9:.3f} GB; " + "; ".join(parts))
    for line in lines:
        print(line)
    hits = {k: int((v == at.cpu().numpy()).sum()) for k, v in
            rank1.items()}
    for kind in ("flat", "IVF"):
        check(np.array_equal(rank1[kind + " int8"],
                             rank1[kind + " none"]),
              f"D={d} {kind}: int8 rank 1 {rank1[kind + ' int8']} != "
              f"fp32 {rank1[kind + ' none']}")
    print(f"[map-scale] D={d}: int8 rank 1 = fp32 rank 1 for 8/8 "
          f"queries, flat and IVF; planted rows at rank 1: {hits}")

    # the int8 product: cuBLASLt int8 against fp32 of the int8 values
    bq = banks["flat int8"][0]._bank
    prods = []
    for qn in (1, 8):
        qq = quantize_rows(queries[:qn])[0]
        prods.append(
            f"Q={qn} int8_dots {cuda_ms(torch, lambda: int8_dots(bq, qq), 20):.4f} ms, "
            f"fp32 product of the int8 values (cast included) "
            f"{cuda_ms(torch, lambda: bq.float() @ qq.float().t(), 20):.4f} ms")
        x = banks["flat none"][0].distances(queries[:qn])
        prods.append(
            f"Q={qn} selection: stable sort "
            f"{cuda_ms(torch, lambda: select_topk(x, MAP_K), 20):.4f} ms,"
            f" torch.topk {cuda_ms(torch, lambda: torch.topk(x, MAP_K, largest=False), 20):.4f} ms")
    print(f"[map-scale] D={d} N={MAP_N} on {card}: " + "; ".join(prods))

    ex = banks["IVF int8"][0].query_device(queries[:1], MAP_K,
                                           exclude_after=MAP_ROW)[1]
    fb = banks["flat int8"][0]
    fb.cfg = fb.cfg.replace(num_exclude_recent=MAP_N - MAP_ROW)
    ex_flat = fb.query_device(queries[:1], MAP_K, exclude_recent=True)[1]
    for name, e in (("IVF", ex), ("flat", ex_flat)):
        e = e.cpu().numpy()
        check(((e < MAP_ROW) | (e == -1)).all() and MAP_ROW not in e,
              f"D={d} {name} int8 exclude: ids {e}")
    print(f"[map-scale] D={d}: exclude below row {MAP_ROW} holds on IVF"
          f" int8 and flat int8 (ids < {MAP_ROW})")

    if d == MAP_DIMS[0]:
        phase_map_scale_checks(torch, banks, queries, dev)
    return summary


def phase_map_scale_checks(torch, banks, queries, dev):
    """IVF at full probe against the flat search; card vs CPU on one saved
    layout; flat int8 and IVF files through save / load on the card."""
    from gloc3d_tpu_torch.index.bank import DescriptorBank
    from gloc3d_tpu_torch.index.ivf import IVFBank

    for quant in ("none", "int8"):
        ivf, flat = banks["IVF " + quant][0], banks["flat " + quant][0]
        got = ivf.query_device(queries[:1], MAP_K, nprobe=IVF_CELLS)[1]
        want = flat.query_device(queries[:1], MAP_K)[1]
        check(torch.equal(got.cpu(), want.cpu()),
              f"IVF {quant} at nprobe {IVF_CELLS} != flat: {got} / {want}")
    print(f"[map-scale] IVF at nprobe={IVF_CELLS} = flat top-{MAP_K} ids, "
          f"fp32 and int8")
    with tempfile.TemporaryDirectory() as tmp:
        for quant in ("none", "int8"):
            path = os.path.join(tmp, f"ivf_{quant}.npz")
            banks["IVF " + quant][0].save(path)
            out = {}
            for where in (dev, torch.device("cpu")):
                back = IVFBank.load(path, device=where)
                out[where.type] = [x.cpu().numpy() for x in
                                   back.query_device(queries.to(where),
                                                     MAP_K)]
                del back
            want = [x.cpu().numpy() for x in banks["IVF " + quant][0]
                    .query_device(queries, MAP_K)]
            card_d2, card_ids = out[dev.type]
            check(np.array_equal(card_ids, want[1]),
                  f"IVF {quant}: loaded on the card != saved")
            check(np.array_equal(card_ids, out["cpu"][1]),
                  f"IVF {quant}: card ids != CPU ids on one layout")
            err = float(np.abs(card_d2 - out["cpu"][0]).max())
            check(err <= 1e-5, f"IVF {quant}: card vs CPU dists² {err}")
            print(f"[map-scale] IVF {quant}: save / load on the card gives "
                  f"the saved map's ids; card = CPU on the loaded layout "
                  f"(8 queries, ids equal, dists² max |diff| {err:.2e}, "
                  f"bound 1e-5)")
        path = os.path.join(tmp, "flat_int8.npz")
        flat = banks["flat int8"][0]
        flat.save(path)
        back = DescriptorBank.load(path, device=dev)
        same = torch.equal(back.query_device(queries, MAP_K)[1],
                           flat.query_device(queries, MAP_K)[1])
        check(back._quantized and same, "flat int8 save / load differs")
        print("[map-scale] flat int8: save / load on the card gives the "
              "saved map's ids")


def phase_city(torch, cfg, centroids, card, flat_ms):
    """tools/bench_city.py's map: CITY_N keyframes on the IVF + int8 bank
    (1024 cells, nprobe 32, capacity max(256, 2n / 1024)) and the device
    store without a host mirror, host stats, fast_match(fm=True), bf16,
    bench.py's synthetic scan planted at row n / 2 as phase_fused_cell
    plants it (random rows elsewhere, as bench_city.py fills them).
    locate_fused must return the planted row and register it."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer, Keyframe

    n, j = CITY_N, CITY_N // 2
    index = cfg.index.replace(
        capacity=n, backend="ivf", quantize="int8", ivf_num_cells=1024,
        ivf_nprobe=32, ivf_cell_capacity=max(256, 2 * n // 1024))
    ccfg = cfg.replace(index=index).fast_match(fm=True)
    pts, mask = bench_query_scan(cfg.voxel.max_points)
    dev = torch.device("cuda")
    loc = GlobalLocalizer(ccfg, build_serving_model(
        torch, cfg, "bfloat16", centroids), device=dev, host_stats=True,
        device_keyframes=True, host_mirror=False)
    desc, bev, _ = loc.extract(pts, mask)
    rng = np.random.RandomState(1)
    for i in range(0, n, 16384):
        m = min(16384, n - i)
        chunk = rng.randn(m, index.dim).astype(np.float32)
        if i <= j < i + m:
            chunk[j - i] = _host(desc[0].float())
        loc.bank.add(chunk)
    s = ccfg.bev.image_size
    loc._kf_store = torch.zeros((n, s, s // 8), dtype=torch.uint8,
                                device=dev)
    loc._kf_origins = torch.zeros((n, 2), device=dev)
    loc._kf_cap = n
    loc._store_keyframes(bev.image[:1], bev.origin_xy[:1], offset=j)
    loc.keyframes = [Keyframe(None, None, None)] * n
    t0 = time.perf_counter()
    loc.bank._flush()  # trains the quantizer and ingests the map
    loc.bank._ivf.device_arrays()
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    res = loc.locate_fused(pts[0], mask[0])
    check(res.success and res.db_index == j, f"city: success {res.success},"
          f" db {res.db_index} (want {j})")
    ivf = loc.bank._ivf
    held = {"store": nbytes(loc._kf_store, loc._kf_origins),
            "IVF": nbytes(ivf.centroids, *ivf.device_arrays())}
    t = [host_ms(torch, lambda: loc.locate_fused(pts[0], mask[0]), 10)
         for _ in range(2)]
    search = cuda_ms(torch, lambda: loc.bank.query_device(desc[:1]), 20)
    print(f"[city] {n} keyframes, IVF + int8 (1024 cells, nprobe 32, cell "
          f"capacity {ivf.cell_capacity}, max cell {int(ivf._sizes.max())}),"
          f" device store without a host mirror, host stats, fm preset, bf16,"
          f" on {card}: db {res.db_index} registered (score "
          f"{res.match_score:.3f}); build (train + ingest) {build:.2f} s; "
          f"locate_fused {t[0]:.3f} / {t[1]:.3f} ms per query (host clock, "
          f"median of 10, twice) against the 10000-row flat fused cell's "
          f"{flat_ms[0]:.3f} / {flat_ms[1]:.3f} ms; the IVF search alone "
          f"{search:.4f} ms (CUDA "
          f"events); device bytes held: store {held['store'] / 1e9:.3f} GB, "
          f"IVF {held['IVF'] / 1e9:.3f} GB "
          f"(torch.cuda.memory_allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB)")
    return {"locate_fused_ms": t, "search_ms": search, "build_s": build,
            "device_bytes": held}


# ------------------------------------------------------------------ shard
SHARD_D = 512      # [map-scale]'s wider D
SHARD_TOL = 1e-5   # world size 2: fp32 d2 of unit rows, ~10x its rounding


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_rank(rank: int, port: int, n: int, seed: int, out: str,
               store_args: tuple) -> None:
    """One of [shard]'s two gloo ranks (torch.multiprocessing spawn), both
    on the one card: each makes [map-scale]'s n rows from ``seed``, keeps
    its half in a ShardedBank (fp32, then int8) and answers the 8 queries;
    then the sharded keyframe store and the sharded matcher
    (shard_store_world, ``store_args``); rank 0 writes the results and the
    host-clock ms per query to ``out``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from gloc3d_tpu_torch.parallel import ShardedBank

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        rows, queries, _ = map_rows(torch, n, SHARD_D, seed)
        rec = {}
        for quant in ("none", "int8"):
            bank = ShardedBank(None, SHARD_D, n, quantize=quant,
                               device="cuda")
            bank.add(rows)
            bank.query(queries, MAP_K)
            t0 = time.perf_counter()
            for _ in range(5):
                d2, idx = bank.query(queries, MAP_K)
            rec[f"{quant}_ms"] = (time.perf_counter() - t0) / 5 * 1e3
            rec[f"{quant}_d2"], rec[f"{quant}_id"] = d2, idx
            rec[f"{quant}_rows"] = bank._bank.shape[0]
            del bank
        del rows, queries
        torch.cuda.empty_cache()
        rec.update(shard_store_world(torch, rank, *store_args))
        if rank == 0:
            np.savez(out, **rec)
    finally:
        dist.destroy_process_group()


def same_ids_where_gapped(tag, got, want_d2, want_id, tol):
    """Ids equal wherever the unsharded distances lie more than ``tol``
    from both neighbours, and every distance within ``tol``."""
    d = np.diff(want_d2, axis=1)
    gap = np.minimum(np.concatenate([np.full((len(d), 1), np.inf), d], 1),
                     np.concatenate([d, np.full((len(d), 1), np.inf)], 1))
    firm = gap > tol
    check(np.array_equal(got[1][firm], want_id[firm]),
          f"{tag}: ids differ where the distances are {tol} apart")
    err = float(np.abs(got[0] - want_d2).max())
    check(err <= tol, f"{tag}: distances {err:.3e} from the unsharded ones")
    return int(firm.sum()), err


SHARD_ROTATIONS = 1572  # the Olson count at 0.2 m over 50 m (1 571), even


def store_map(torch, cfg, model, kf, device="cuda"):
    """Phase 5's host-stats map with the device keyframe store and no host
    mirror."""
    return build_map(torch, cfg, model, kf, device, host_stats=True,
                     device_keyframes=True, host_mirror=False)


def store_queries(loc, qs) -> dict:
    """locate, locate_batch and locate_fused on every query."""
    return {"locate": [loc.locate(*q) for q in qs],
            "locate_batch": loc.locate_batch(np.stack([q[0] for q in qs]),
                                             np.stack([q[1] for q in qs])),
            "locate_fused": [loc.locate_fused(*q) for q in qs]}


def bit_equal_results(tag, got: dict, want: dict) -> int:
    """Every result of ``got`` equal to ``want``'s bit for bit: success,
    keyframe, ranked candidates and their distances, score, (dx, dy, yaw).
    Returns the number of results compared."""
    n = 0
    for mode, rows in want.items():
        for i, (a, b) in enumerate(zip(got[mode], rows)):
            xy_a, xy_b = a.match_xy_yaw, b.match_xy_yaw
            same = (a.success == b.success and a.db_index == b.db_index
                    and np.array_equal(a.candidates, b.candidates)
                    and np.array_equal(a.candidate_dists, b.candidate_dists)
                    and a.match_score == b.match_score
                    and (xy_a is None) == (xy_b is None)
                    and (xy_a is None or np.array_equal(xy_a, xy_b)))
            check(same, f"{tag} {mode} query {i}: db {a.db_index} / "
                  f"{b.db_index}, candidates {a.candidates} / "
                  f"{b.candidates}, score {a.match_score} / {b.match_score}")
            n += 1
    return n


def store_add_check(torch, tag, loc, q) -> int:
    """An add after sharding: the query scan q as a new keyframe lands in
    its row, bit for bit the packed BEV of its extraction, and q then
    localizes to it. Returns the new row's index."""
    from gloc3d_tpu_torch.pipeline import _pack_bits

    row = len(loc.keyframes)
    _, bev, _ = loc.extract(q[0][None], q[1][None])
    loc.add_keyframes(q[0][None], q[1][None])
    packed = loc._store_rows(np.array([row]))[0]
    check(torch.equal(packed, _pack_bits(torch.as_tensor(
        _host(bev.image), device=packed.device))),
          f"{tag}: the row added after sharding differs from its BEV")
    res = loc.locate(*q)
    check(res.success and res.db_index == row,
          f"{tag}: the added keyframe's own scan located db {res.db_index}")
    return row


def matcher_case(torch, loc, kf):
    """The sharded matcher's input: the 512² centre crop (SUBMAP_CROP) of
    keyframe 0's BEV on the located map as the grid, and bench_submap.py's
    offset query (SUBMAP_GT, σ 0.10 m) of a SUBMAP_POINTS-point virtual
    scan of that BEV, as numpy: (crop, its origin, the query)."""
    _, bev, _ = loc.extract(kf[0][0][None], kf[0][1][None])
    img, org = _host(bev.image)[0], _host(bev.origin_xy)[0]
    res = loc.cfg.bev.resolution
    a, b = SUBMAP_CROP
    occ = np.argwhere(img < 0.5)
    sel = np.random.RandomState(0).choice(len(occ), SUBMAP_POINTS,
                                          replace=len(occ) < SUBMAP_POINTS)
    vscan = (occ[sel][:, ::-1] * res + org[None, :]).astype(np.float32)
    return (np.ascontiguousarray(img[a:b, a:b]),
            (org + a * res).astype(np.float32),
            offset_query(vscan, SUBMAP_GT[:2], SUBMAP_GT[2], 0.10, 100))


def matcher_inputs(torch, case, res: float, device="cuda"):
    from gloc3d_tpu_torch.ops.occupancy import ProbabilityGrid2D

    crop, origin, q = case
    grid = ProbabilityGrid2D.from_bev_image(
        torch.from_numpy(crop).to(device), origin, res)
    return (grid, torch.from_numpy(q).to(device),
            torch.ones(len(q), device=device))


def sharded_match(torch, grid, q, mask):
    from gloc3d_tpu_torch.ops.scan_match import match_scan_fast_sharded

    return match_scan_fast_sharded(None, grid, q, mask, SHARD_ROTATIONS,
                                   num_candidates=SHARD_ROTATIONS)


def shard_store_world(torch, rank, cfg, state, kf, qs, case, tmp) -> dict:
    """The sharded keyframe store and matcher in one rank of a group of
    two: the store map built from ``state``, its results before and after
    shard_keyframes bit-equal, the rank's store bytes, a save (rank 0
    writes), an add after sharding; match_scan_fast_sharded on ``case``.
    Returns what rank 0 reports."""
    from gloc3d_tpu_torch.models.descriptor import build_model

    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(state)
    loc = store_map(torch, cfg, model.eval(), kf)
    want = store_queries(loc, qs)
    rec = {"store_flat_ms": host_ms(torch, lambda: loc.locate(*qs[0]), 5),
           "store_db": [r.db_index for r in want["locate"]]}
    loc.shard_keyframes(None)
    got, rec["store_k1_launches"] = sharded_store_queries(
        f"[shard] world 2 rank {rank}", loc, qs)
    rec["store_compared"] = bit_equal_results(
        f"[shard] world 2 rank {rank} sharded store", got, want)
    rec["store_ms"] = host_ms(torch, lambda: loc.locate(*qs[0]), 5)
    rec["store_local_rows"] = loc._kf_store.shape[0]
    rec["store_bytes"] = nbytes(loc._kf_store, loc._kf_origins)
    loc.save(os.path.join(tmp, "map_world2"))
    rec["store_added_row"] = store_add_check(
        torch, f"[shard] world 2 rank {rank}", loc, qs[0])
    grid, q, mask = matcher_inputs(torch, case, cfg.bev.resolution)
    res, cert = sharded_match(torch, grid, q, mask)
    rec.update(match_pose=res.pose.cpu().numpy(),
               match_score=float(res.score), match_cert=bool(cert),
               match_ms=host_ms(torch, lambda: sharded_match(
                   torch, grid, q, mask), 3))
    return rec


def sharded_store_queries(tag, loc, qs):
    """store_queries on a sharded store, its K1 launches counted: one per
    query extraction of locate and locate_fused, one for locate_batch's
    batch, and one for each capture of locate_fused's program (its run
    before the capture; a store sharded over gloo runs it uncaptured).
    Returns (results, launches)."""
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    reset_launches(ss.segment_sum_sorted)
    captured = ss.segment_sum_sorted.captured
    got = store_queries(loc, qs)
    launches = launches_of(ss.segment_sum_sorted)
    want = 2 * len(qs) + 1 + ss.segment_sum_sorted.captured - captured
    check(launches == want, f"{tag} sharded store: K1 launched {launches} "
          f"times, not {want}")
    return got, launches


def phase_shard_store(torch, card, cfg, loc, kf, qs, tmp) -> dict:
    """[shard]'s keyframe store at world size 1 (NCCL, in this process):
    phase 5's map with the device store, its locate / locate_batch /
    locate_fused before and after shard_keyframes bit-equal; the save with
    host_mirror=False = the unsharded save; an add after sharding; the
    saved map loaded into a sharded localizer = the unsharded results.
    K1 launches of the sharded store's queries counted."""
    sloc = store_map(torch, cfg, loc.model, kf)
    want = store_queries(sloc, qs)
    rec = {"unsharded_bytes": nbytes(sloc._kf_store, sloc._kf_origins)}
    sloc.save(os.path.join(tmp, "map_flat"))
    t_flat = host_ms(torch, lambda: sloc.locate(*qs[0]), 5)
    sloc.shard_keyframes(None)
    got, rec["k1_launches"] = sharded_store_queries("[shard] world 1", sloc,
                                                    qs)
    rec["compared"] = bit_equal_results("[shard] world 1 sharded store",
                                        got, want)
    rec["locate_ms"] = [t_flat, host_ms(torch, lambda: sloc.locate(*qs[0]),
                                        5)]
    rec["world1_bytes"] = nbytes(sloc._kf_store, sloc._kf_origins)
    sloc.save(os.path.join(tmp, "map_world1"))
    same_map(os.path.join(tmp, "map_flat"), os.path.join(tmp, "map_world1"),
             "[shard] world 1")
    rec["added_row"] = store_add_check(torch, "[shard] world 1", sloc, qs[0])
    back = store_map(torch, cfg, loc.model, kf[:1])
    back.shard_keyframes(None)
    back.load(os.path.join(tmp, "map_world1"))
    bit_equal_results("[shard] world 1 sharded store loaded",
                      {"locate": [back.locate(*q) for q in qs]},
                      {"locate": want["locate"]})
    return rec


def same_map(a: str, b: str, tag: str) -> None:
    """Two saved maps' keyframes.npz: images and origins bit-equal."""
    x = np.load(os.path.join(a, "keyframes.npz"))
    y = np.load(os.path.join(b, "keyframes.npz"))
    check(np.array_equal(x["images"], y["images"])
          and np.array_equal(x["origins"], y["origins"]),
          f"{tag}: the sharded store's saved map differs from the "
          f"unsharded one's")


def phase_shard(torch, card, cfg, loc, kf, qs, seed: int = 0):
    with tempfile.TemporaryDirectory() as tmp:
        return shard_phase(torch, card, cfg, loc, kf, qs, seed, tmp)


def shard_phase(torch, card, cfg, loc, kf, qs, seed, tmp):
    """[shard]: the sharded search on the card. World size 1 over NCCL in
    this process: sharded_topk, sharded_topk_int8 and ShardedBank at
    [map-scale]'s shapes (MAP_N rows, D = 512, Q = 8, k = 20) and a
    ShardedIVF over [city]'s index (CITY_N rows, IVF + int8, 1024 cells,
    nprobe 32), each held to its unsharded call (ids equal, distances
    bit-equal), and shard_bank + locate on the host-stats located map = its
    unsharded locate (ranked); then world size 2 over gloo, two spawned
    ranks on the one card with MAP_N / 2 rows each, ids equal to the
    unsharded call's wherever neighbouring distances lie SHARD_TOL apart.
    Then the sharded keyframe store on phase 5's map with the device store
    (768² bitmaps; phase_shard_store, and the same in both world-2 ranks:
    results before and after shard_keyframes bit-equal, the saved map =
    the unsharded save, an add after sharding) and match_scan_fast_sharded
    at SHARD_ROTATIONS on a 512² grid (matcher_case): world 1 = the
    unsharded match_scan_fast bit for bit; world 2 the same certified
    optimum, the score within 1e-4. Prints the sharded times beside the
    unsharded ones (the all-gather's cost): CUDA events for the
    device-side calls, host clock for the calls that return numpy."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from gloc3d_tpu_torch.ops import scan_match as sm

    from gloc3d_tpu_torch.config import IndexConfig
    from gloc3d_tpu_torch.index.bank import DescriptorBank
    from gloc3d_tpu_torch.index.ivf import IVFBank, ShardedIVF
    from gloc3d_tpu_torch.ops.topk import l2_topk, l2_topk_int8, quantize_rows
    from gloc3d_tpu_torch.parallel import (
        ShardedBank, sharded_topk, sharded_topk_int8,
    )

    rec = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        rows, queries, _ = map_rows(torch, MAP_N, SHARD_D, seed)
        codes, scales, bsq = quantize_rows(rows)
        calls = {
            "flat fp32": (lambda: l2_topk(queries, rows, MAP_K),
                          lambda: sharded_topk(None, queries, rows, MAP_K)),
            "flat int8": (lambda: l2_topk_int8(queries, codes, scales, bsq,
                                               MAP_K),
                          lambda: sharded_topk_int8(None, queries, codes,
                                                    scales, bsq, MAP_K))}
        for name, (plain, sharded) in calls.items():
            a, b = plain(), sharded()
            check(torch.equal(a[1], b[1]) and torch.equal(a[0], b[0]),
                  f"[shard] {name}: sharded_topk differs from l2_topk")
            rec[name] = [cuda_ms(torch, plain, 20), cuda_ms(torch, sharded, 20)]
        for quant in ("none", "int8"):
            flat = DescriptorBank(IndexConfig(dim=SHARD_D, capacity=MAP_N,
                                              top_k=MAP_K, quantize=quant),
                                  device="cuda")
            flat.add(rows)
            bank = ShardedBank(None, SHARD_D, MAP_N, quantize=quant,
                               device="cuda")
            bank.add(rows)
            a, b = flat.query(queries, MAP_K), bank.query(queries, MAP_K)
            check(np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0]),
                  f"[shard] ShardedBank {quant} differs from DescriptorBank")
            rec[f"ShardedBank {quant}"] = [
                host_ms(torch, lambda: flat.query(queries, MAP_K), 20),
                host_ms(torch, lambda: bank.query(queries, MAP_K), 20)]
            del flat, bank
        del rows, codes, scales, bsq
        torch.cuda.empty_cache()

        city, cq, _ = map_rows(torch, CITY_N, cfg.index.dim, seed + 1)
        ivf = IVFBank(cfg.index.dim, 1024, 256, 32, quantize="int8",
                      device="cuda")
        ivf.train(city[:IVF_TRAIN].cpu().numpy(),
                  torch.Generator().manual_seed(seed), iters=10)
        ivf.add(city.cpu().numpy())
        sharded_ivf = ShardedIVF(None, ivf)
        a, b = ivf.query_device(cq, MAP_K), sharded_ivf.query_device(cq, MAP_K)
        check(torch.equal(a[1], b[1]) and torch.equal(a[0], b[0]),
              "[shard] ShardedIVF differs from IVFBank")
        rec["IVF int8 (city)"] = [
            cuda_ms(torch, lambda: ivf.query_device(cq, MAP_K), 20),
            cuda_ms(torch, lambda: sharded_ivf.query_device(cq, MAP_K), 20)]
        del city, ivf, sharded_ivf

        flat_bank = loc.bank
        want = [loc.locate(*q) for q in qs]
        t_flat = host_ms(torch, lambda: loc.locate(*qs[0]), 5)
        try:
            loc.shard_bank(None)
            got = [loc.locate(*q) for q in qs]
            t_shard = host_ms(torch, lambda: loc.locate(*qs[0]), 5)
        finally:
            loc.bank = flat_bank
        dxy = same_results("[shard] shard_bank locate vs locate", got,
                              want)
        rec["locate, host-stats map"] = [t_flat, t_shard]

        store = phase_shard_store(torch, card, cfg, loc, kf, qs, tmp)
        rec["store locate, host-stats map"] = store.pop("locate_ms")
        case = matcher_case(torch, loc, kf)
        grid, q, mask = matcher_inputs(torch, case, cfg.bev.resolution)

        def single():
            return sm.match_scan_fast(grid, q, mask, SHARD_ROTATIONS,
                                      num_candidates=SHARD_ROTATIONS)

        (m1, c1), (ms, cs) = single(), sharded_match(torch, grid, q, mask)
        check(torch.equal(m1.pose, ms.pose) and torch.equal(m1.score,
                                                            ms.score)
              and bool(c1) == bool(cs), "[shard] world 1 "
              "match_scan_fast_sharded differs from match_scan_fast")
        exact = sm.match_scan(grid, q, mask, SHARD_ROTATIONS)
        check(not bool(c1) or same_optimum(torch, sm.score_at, grid, q,
                                           mask, m1, exact, 1e-4),
              "[shard] a certified match_scan_fast is not the optimum")
        rec[f"match_scan_fast R={SHARD_ROTATIONS}"] = [
            cuda_ms(torch, single, 3),
            cuda_ms(torch, lambda: sharded_match(torch, grid, q, mask), 3)]
    finally:
        dist.destroy_process_group()

    state = {k: v.cpu() for k, v in loc.model.state_dict().items()}
    store_args = (cfg, state, kf, qs, case, tmp)
    out = os.path.join(tmp, "rank0.npz")
    t0 = time.perf_counter()
    mp.spawn(shard_rank, args=(free_port(), MAP_N, seed, out, store_args),
             nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    two = dict(np.load(out))
    same_map(os.path.join(tmp, "map_flat"), os.path.join(tmp, "map_world2"),
             "[shard] world 2")
    check(int(two["store_local_rows"]) == 512 and int(two["store_bytes"])
          * 2 == store["unsharded_bytes"], f"[shard] world 2: rank 0 "
          f"holds {int(two['store_local_rows'])} store rows")
    w2_pose = torch.from_numpy(two["match_pose"])
    w2 = sm.ScanMatchResult(w2_pose.to(grid.log_odds.device),
                            torch.tensor(float(two["match_score"])))
    check(not bool(c1) or bool(two["match_cert"]),
          "[shard] world 2: the sharded matcher lost the certificate")
    check(not bool(two["match_cert"]) or same_optimum(
        torch, sm.score_at, grid, q, mask, w2, exact, 1e-4),
          "[shard] world 2: a certified sharded optimum is not the optimum")
    check(float(two["match_score"]) >= float(m1.score) - 1e-4,
          "[shard] world 2: the sharded matcher scored below the unsharded")
    check(not (bool(c1) and bool(two["match_cert"])) or abs(
        float(two["match_score"]) - float(m1.score)) <= 1e-4,
          "[shard] world 2: the certified scores differ by more than 1e-4")
    w1_ms = rec[f"match_scan_fast R={SHARD_ROTATIONS}"]
    print(f"[shard] sharded keyframe store on phase 5's map ({N_KEYFRAMES} "
          f"keyframes, 768² bitmaps, host stats, no host mirror): "
          f"locate / locate_batch / locate_fused before and after "
          f"shard_keyframes bit-equal ({store['compared']} results at world "
          f"1, NCCL; {int(two['store_compared'])} on each world-2 rank, "
          f"gloo); the saved maps = the unsharded save; a keyframe added "
          f"after sharding (row {store['added_row']}) localizes its scan; "
          f"the map loaded into a sharded localizer = unsharded; store "
          f"bytes unsharded {store['unsharded_bytes']}, world 1 "
          f"{store['world1_bytes']}, world 2 rank 0 "
          f"{int(two['store_bytes'])} ({int(two['store_local_rows'])} "
          f"rows); locate ms (host clock) unsharded → world 1: "
          f"{rec['store locate, host-stats map'][0]:.3f} → "
          f"{rec['store locate, host-stats map'][1]:.3f}, world 2 rank 0 "
          f"{float(two['store_flat_ms']):.3f} → "
          f"{float(two['store_ms']):.3f}; K1 launches of the sharded "
          f"store's queries (locate, locate_batch, locate_fused) world 1 "
          f"{store['k1_launches']}, world 2 rank 0 "
          f"{int(two['store_k1_launches'])}")
    print(f"[shard] match_scan_fast_sharded R={SHARD_ROTATIONS} on the 512² "
          f"grid ({SUBMAP_POINTS}-point offset query): world 1 = "
          f"match_scan_fast bit for bit (certified {bool(c1)}, score "
          f"{float(m1.score):.6f}; exhaustive {float(exact.score):.6f}); "
          f"world 2 certified {bool(two['match_cert'])}, score "
          f"{float(two['match_score']):.6f}; ms unsharded {w1_ms[0]:.3f} → "
          f"world 1 {w1_ms[1]:.3f} (CUDA events) → world 2 "
          f"{float(two['match_ms']):.3f} (host clock, rank 0)")
    rec["store"] = store
    rec["store world 2"] = {k: float(two[k]) for k in (
        "store_flat_ms", "store_ms", "store_bytes", "store_local_rows",
        "store_k1_launches")}
    rec["matcher"] = {"certified": bool(c1), "score": float(m1.score),
                      "exhaustive_score": float(exact.score),
                      "world2_certified": bool(two["match_cert"]),
                      "world2_score": float(two["match_score"]),
                      "world2_ms": float(two["match_ms"])}
    rows, queries, _ = map_rows(torch, MAP_N, SHARD_D, seed)
    codes, scales, bsq = quantize_rows(rows)
    world2 = {"seconds": spawn_s}
    for quant, want in (("none", l2_topk(queries, rows, MAP_K)),
                        ("int8", l2_topk_int8(queries, codes, scales, bsq,
                                              MAP_K))):
        check(int(two[f"{quant}_rows"]) == MAP_N // 2,
              f"[shard] world 2: a rank holds {two[f'{quant}_rows']} rows")
        firm, err = same_ids_where_gapped(
            f"[shard] world 2 {quant}", (two[f"{quant}_d2"],
                                         two[f"{quant}_id"]),
            _host(want[0]), _host(want[1]), SHARD_TOL)
        world2[quant] = {"query_ms": float(two[f"{quant}_ms"]),
                         "ids_held": firm, "max_d2_err": err}
    rec["world 2 (gloo)"] = world2
    del rows, codes, scales, bsq
    torch.cuda.empty_cache()
    times = "; ".join(f"{k} {v[0]:.4f} → {v[1]:.4f} ms"
                      for k, v in rec.items() if isinstance(v, list))
    print(f"[shard] world size 1 (NCCL) on {card}: every sharded call = its "
          f"unsharded one (ids equal, distances bit-equal; locate ranked, "
          f"xy_yaw {dxy:.1e}); unsharded → sharded: {times}")
    print(f"[shard] world size 2 (gloo, two spawned ranks on one card, "
          f"{MAP_N // 2} rows each, CUDA tensors): ids equal where the "
          f"distances lie {SHARD_TOL} apart "
          f"({world2['none']['ids_held']} / {world2['int8']['ids_held']} of "
          f"{8 * MAP_K}, fp32 / int8), distances within "
          f"{world2['none']['max_d2_err']:.1e} / "
          f"{world2['int8']['max_d2_err']:.1e}; query "
          f"{world2['none']['query_ms']:.3f} / {world2['int8']['query_ms']:.3f}"
          f" ms (host clock, rank 0); spawn to join {spawn_s:.1f} s")
    return rec


SPATIAL_ZOO = (("resnet18", 512), ("mobilenet", 320), ("alexnet", 256))
# [spatial]: the spatial forward against the unsharded one, fp32 with TF32
# off, max |difference| over max |unsharded descriptor|, a bound for each
# encoder. On an H100 80GB HBM3 at 700 W every encoder read 0 at world 1;
# at world 2 VGG16 read 6.4e-5 (B=8; 1.8e-6 at B=1) beside the unsharded
# forward's own spread between a batch of 8 and the same images one by one
# of 1.2e-4 (cuDNN picks its algorithms by shape), which the phase prints;
# the zoo read at most 7.2e-6 (AlexNet B=8; ResNet18 5.5e-6, MobileNetV2
# 3.3e-6) beside spreads of at most 6.6e-6. Each bound is about four times
# its encoders' largest reading and above their own spread.
SPATIAL_TOL = {"vgg16": 2e-4, "resnet18": 3e-5, "mobilenet": 3e-5,
               "alexnet": 3e-5}


SPATIAL_KEYS = tuple(f"{enc} B={b}" for enc in SPATIAL_TOL for b in (1, 8))


def spatial_models(torch, cfg, images, device="cuda") -> dict:
    """[spatial]'s fp32 models: PipelineConfig.i2i()'s VGG16 + NetVLAD-FC
    and the zoo encoders with the same head, from the port's seeded init,
    each NetVLAD's centroids drawn from its own normalised local features
    of ``images`` (alpha 30, as i2i_centroids)."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params

    models = {}
    for enc, dim in (("vgg16", cfg.model.encoder_dim),) + SPATIAL_ZOO:
        c = cfg.replace(model=cfg.model.replace(
            encoder=enc, encoder_dim=dim, compute_dtype="float32"))
        model = init_params(build_model(c.model, c.voxel), seed=0).to(
            device).eval()
        with torch.no_grad():
            f = torch.nn.functional.normalize(model.encode(
                torch.from_numpy(images).to(device)).reshape(-1, dim),
                dim=-1)
            pick = torch.randperm(f.shape[0], generator=torch.Generator(
            ).manual_seed(0))[: c.model.num_clusters].to(device)
            model.pool.centroids.copy_(f[pick])
            model.pool.conv.weight.copy_(30.0 * f[pick][:, :, None, None])
        models[enc] = (c, model)
    return models


def spatial_run(torch, models, data, timed: bool) -> dict:
    """spatial_sharded_apply of every model at B=1 and B=8 on the query
    images, and shard_spatial on the VGG16 localizer: the keyframe images
    added, locate of query 0, locate_batch of all 8. With ``timed``, the
    B=1 VGG16 spatial forward's ms (host clock: gloo ranks wait on the
    host)."""
    from gloc3d_tpu_torch.parallel import spatial_sharded_apply
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    kf_img, kf_org, q_img, q_org = data
    rec = {}
    for enc, (c, model) in models.items():
        fn = spatial_sharded_apply(None, model)
        rec[f"{enc} B=1"] = fn(q_img[:1]).cpu().numpy()
        rec[f"{enc} B=8"] = fn(q_img).cpu().numpy()
        if timed and enc == "vgg16":
            rec["vgg16 B=1 ms"] = host_ms(torch, lambda: fn(q_img[:1]), 5)
    c, model = models["vgg16"]
    loc = GlobalLocalizer(c, model, device=torch.device("cuda"))
    loc.shard_spatial(None)
    for i in range(0, len(kf_img), 4):
        loc.add_keyframes(kf_img[i:i + 4], origins=kf_org[i:i + 4])
    rec["locate"] = [loc.locate(q_img[0], origin=q_org[0])]
    rec["locate_batch"] = loc.locate_batch(q_img, origins=q_org)
    return rec


def spatial_rank(rank: int, n: int, device, tmp: str, cfg) -> None:
    """One of [spatial]'s two gloo ranks on the one card
    (parallel/launch.py): spatial_run on the models and images the parent
    wrote; rank 0 writes the descriptors, times and results, rank 1 its
    descriptors."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from gloc3d_tpu_torch.models.descriptor import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(os.path.join(tmp, "images.npz")) as f:
        data = tuple(f[k] for k in ("kf_img", "kf_org", "q_img", "q_org"))
    models = {}
    for enc, dim in (("vgg16", cfg.model.encoder_dim),) + SPATIAL_ZOO:
        c = cfg.replace(model=cfg.model.replace(
            encoder=enc, encoder_dim=dim, compute_dtype="float32"))
        model = build_model(c.model, c.voxel)
        model.load_state_dict(torch.load(os.path.join(tmp, f"{enc}.pt")))
        models[enc] = (c, model.to(device).eval())
    rec = spatial_run(torch, models, data, timed=True)
    if rank == 1:  # every rank returns the same descriptors
        np.savez(os.path.join(tmp, "rank1.npz"), **{
            k: v for k, v in rec.items() if k in SPATIAL_KEYS})
    else:
        for key in ("locate", "locate_batch"):
            for i, r in enumerate(rec.pop(key)):
                rec[f"{key} {i} db"] = r.db_index
                rec[f"{key} {i} ok"] = r.success
                rec[f"{key} {i} cand"] = r.candidates
                rec[f"{key} {i} xy"] = (np.full(3, np.nan) if r.match_xy_yaw
                                        is None else r.match_xy_yaw)
        np.savez(os.path.join(tmp, "rank0.npz"), **rec)
    dist.barrier()


def spatial_errors(tag, got: dict, want: dict) -> dict:
    """max |got − want| over max |want| of every descriptor batch, each
    within its encoder's SPATIAL_TOL."""
    errs = {}
    for key, ref in want.items():
        err = float(np.abs(got[key] - ref).max() / np.abs(ref).max())
        tol = SPATIAL_TOL[key.split()[0]]
        check(err <= tol, f"{tag} {key}: the spatial forward is "
              f"{err:.3e} (relative) from the unsharded one, > {tol}")
        errs[key] = err
    return errs


def phase_spatial(torch, card, lq_set):
    """[spatial] (27): the i2i spatial partition (parallel/spatial.py,
    GlobalLocalizer.shard_spatial) at PipelineConfig.i2i()'s full width
    (VGG16 + NetVLAD-FC, 768² images, the 512-d descriptor) and the zoo
    encoders (ResNet18, MobileNetV2, AlexNet) in fp32 with TF32 off, on
    the located world's BEVs rendered as images (16 keyframes, 8
    queries). World size 1 over NCCL in this process and 2 over gloo (two
    ranks spawned on the one card): every spatial forward at B=1 and B=8
    within its encoder's SPATIAL_TOL of the unsharded forward, rank 1's
    descriptors = rank 0's bit for bit; shard_spatial + locate
    (B=1) and locate_batch (B=8) = the unsharded localizer's (success,
    keyframe, ranked candidates, (dx, dy, yaw) within 1e-4). The B=1
    VGG16 forward's ms at each world size beside the unsharded one's. Two
    gloo ranks on one card share its SMs and pass every halo through the
    host: no speed-up can show there."""
    import torch.distributed as dist

    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.parallel import spatial_sharded_apply
    from gloc3d_tpu_torch.parallel.launch import spawn
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    cfg = PipelineConfig.i2i()
    (_, kf), (_, qs) = lq_set
    kf_img, kf_org = render_bevs(torch, cfg, kf)
    q_img, q_org = render_bevs(torch, cfg, qs)
    data = (kf_img, kf_org, q_img, q_org)
    models = spatial_models(torch, cfg, kf_img[:4])
    want, ms, floor = {}, {}, {}
    with torch.no_grad():
        for enc, (_, model) in models.items():
            for b in (1, 8):
                want[f"{enc} B={b}"] = model(torch.from_numpy(
                    q_img[:b]).cuda()).cpu().numpy()
            ones = np.concatenate([model(torch.from_numpy(
                q_img[i:i + 1]).cuda()).cpu().numpy() for i in range(8)])
            ref = want[f"{enc} B=8"]
            floor[enc] = float(np.abs(ones - ref).max() / np.abs(ref).max())
        vgg = models["vgg16"][1]
        one = torch.from_numpy(q_img[:1]).cuda()
        ms["unsharded"] = cuda_ms(torch, lambda: vgg(one), 5)
    c, model = models["vgg16"]
    base = GlobalLocalizer(c, model, device=torch.device("cuda"))
    for i in range(0, len(kf_img), 4):
        base.add_keyframes(kf_img[i:i + 4], origins=kf_org[i:i + 4])
    plain = {"locate": [base.locate(q_img[0], origin=q_org[0])],
             "locate_batch": base.locate_batch(q_img, origins=q_org)}
    del base

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        one_rank = spatial_run(torch, models, data, timed=False)
        vfn = spatial_sharded_apply(None, models["vgg16"][1])
        ms["world 1"] = cuda_ms(torch, lambda: vfn(q_img[:1]), 5)
    finally:
        dist.destroy_process_group()
    err1 = spatial_errors("[spatial] world 1", one_rank, want)
    d1 = max(same_results(f"[spatial] world 1 {k}", one_rank[k], plain[k])
             for k in plain)

    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "images.npz"), kf_img=kf_img,
                 kf_org=kf_org, q_img=q_img, q_org=q_org)
        for enc, (_, model) in models.items():
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       os.path.join(tmp, f"{enc}.pt"))
        t0 = time.perf_counter()
        spawn(spatial_rank, 2, "cuda", args=(tmp, cfg))
        spawn_s = time.perf_counter() - t0
        two = dict(np.load(os.path.join(tmp, "rank0.npz")))
        rank1 = dict(np.load(os.path.join(tmp, "rank1.npz")))
    check(sorted(rank1) == sorted(want) and all(
        np.array_equal(rank1[k], two[k]) for k in want),
          "[spatial] world 2: rank 1's descriptors differ from rank 0's")
    err2 = spatial_errors("[spatial] world 2", two, want)
    d2 = 0.0
    for key, rows in plain.items():
        for i, r in enumerate(rows):
            same = (bool(two[f"{key} {i} ok"]) == r.success
                    and int(two[f"{key} {i} db"]) == r.db_index
                    and np.array_equal(two[f"{key} {i} cand"],
                                       r.candidates))
            check(same, f"[spatial] world 2 {key} query {i}: db "
                  f"{int(two[f'{key} {i} db'])} / {r.db_index}")
            if r.success:
                d = float(np.abs(two[f"{key} {i} xy"]
                                 - r.match_xy_yaw).max())
                check(d <= 1e-4, f"[spatial] world 2 {key} query {i}: "
                      f"xy_yaw differs by {d:.3e}")
                d2 = max(d2, d)
    ms["world 2"] = float(two["vgg16 B=1 ms"])
    worst = {k: max(err1[k], err2[k]) for k in want}
    print(f"[spatial] {card}, fp32, TF32 off: spatial_sharded_apply against "
          f"the unsharded forward, max |diff| / max |descriptor| at world 1 "
          f"(NCCL) / world 2 (gloo): " + "; ".join(
              f"{k} {err1[k]:.2e} / {err2[k]:.2e}" for k in want)
          + f" (bounds {SPATIAL_TOL}); rank 1's descriptors = rank 0's bit "
          f"for bit; the unsharded forward's own spread, "
          f"B=8 against the same images one by one: " + "; ".join(
              f"{k} {v:.2e}" for k, v in floor.items()))
    print(f"[spatial] shard_spatial + locate (B=1) and locate_batch (B=8) "
          f"on the VGG16 map ({len(kf_img)} keyframe images) = the unsharded "
          f"localizer (success, keyframe, ranked candidates; xy_yaw max "
          f"|diff| {d1:.1e} world 1, {d2:.1e} world 2, bound 1e-4)")
    print(f"[spatial] VGG16 + NetVLAD-FC B=1 {cfg.bev.image_size}² "
          f"forward: unsharded "
          f"{ms['unsharded']:.3f} ms, world 1 {ms['world 1']:.3f} ms (CUDA "
          f"events), world 2 {ms['world 2']:.3f} ms (host clock, rank 0; two "
          f"gloo ranks share the one card: no speed-up can show); spawn to "
          f"join {spawn_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    return {"relative_err": worst, "unsharded_spread": floor,
            "forward_ms": ms, "spawn_s": spawn_s,
            "xy_yaw_diff": max(d1, d2)}


DP_ENCODER = "resnet18"  # [dp]'s i2i case: a zoo encoder with BatchNorm
# The DP step's gradients against the unsharded step's, relative to their
# norm: all trainable tensors together (DP_GRAD_TOL) and each tensor alone
# (DP_TENSOR_TOL). On an H100 (fp32, TF32 off) sound DP steps read
# 1.4-3.4e-3 together and 2.1-6.7e-3 in the worst tensor, and the unsharded
# step's own change on its batch reversed 1.2-2.5e-3 together; a per-rank
# BatchNorm or loss normaliser moves the updates by 0.7-1.6 of their norm
# (tests/test_torch_dp.py).
DP_GRAD_TOL = 2e-2
DP_TENSOR_TOL = 5e-2
DP_TIMED = 3             # timed _train_batch calls after one warm-up
# the launches each [dp] case must show: (K1 > 0, K2 > 0)
DP_KERNELS = {"host-stats": (True, False), "all-device": (False, True),
              "aligned": (False, True), "i2i": (False, False),
              "i2i images": (False, False)}


def dp_cases(cfg):
    """[dp]'s train configurations, fp32 (TF32 off): the [train] phase's
    s2s model on the all-device and host-stats paths, and the [i2i-train]
    zoo's ResNet18 at 768² (BatchNorm in the encoder) under its freeze
    mask, margin 10."""
    from gloc3d_tpu_torch import PipelineConfig

    s2s = cfg.replace(
        model=cfg.model.replace(fold_bn=False, compute_dtype="float32"),
        train=cfg.train.replace(cache_refresh_rate=N_TRAIN_Q))
    i2i = PipelineConfig.i2i(DP_ENCODER)
    i2i = i2i.replace(model=i2i.model.replace(compute_dtype="float32"),
                      train=i2i.train.replace(cache_refresh_rate=N_TRAIN_Q,
                                              margin=10.0))
    return {"all-device": s2s.replace(train=s2s.train.replace(
                host_stats=False)),
            "host-stats": s2s.replace(train=s2s.train.replace(
                host_stats=True)),
            "i2i": i2i}


def dp_datasets(torch, cases, world):
    """The training world's scans (training_dataset) for the s2s cases and
    their 768² BEVs (i2i_training_dataset) for the i2i case."""
    s2s = training_dataset(world, cases["all-device"].voxel.max_points)
    return {"all-device": s2s, "host-stats": s2s,
            "i2i": i2i_training_dataset(torch, cases["i2i"], world)}


def dp_batch(torch, ds, cfg, s2s: bool, reverse: bool = False):
    """The fixed mined batch of [dp]'s steps, as train_step's arguments:
    queries 0-1, each one's nearest db scan as its positive and its first
    n_neg db scans beyond 20 m as its negatives, the last negative slot of
    query 1 padding, and a fixed yaw (s2s); with ``reverse``, the queries
    and each query's negatives in reverse order (the same step, summed in
    another order)."""
    from gloc3d_tpu_torch.train.trainer import draw_aug_yaw

    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    order = np.arange(b)[::-1] if reverse else np.arange(b)
    dist = np.linalg.norm(ds.utm_q[order, None] - ds.utm_db[None], axis=-1)
    pos = dist.argmin(1)
    negs = np.stack([np.flatnonzero(d > 20.0)[:n_neg] for d in dist])
    nv = np.ones((b, n_neg), np.float32)
    nv[order == 1, -1] = 0.0
    if reverse:
        negs, nv = negs[:, ::-1], nv[:, ::-1]
    neg = negs.reshape(-1)
    nv = np.ascontiguousarray(nv)
    qv = np.ones(b, np.float32)
    if not s2s:
        return (ds.q_inputs[order], None, ds.db_inputs[pos], None,
                ds.db_inputs[neg], None, nv, qv)
    yaw = draw_aug_yaw(torch.Generator().manual_seed(1), b)[order.copy()]
    return (ds.q_inputs[order], ds.q_masks[order], ds.db_inputs[pos],
            ds.db_masks[pos], ds.db_inputs[neg], ds.db_masks[neg], nv, qv,
            yaw)


def dp_initial_state(torch, key, cfg, ds):
    """The case's initial weights on the CPU: the [train] phase's model
    (seeded, NetVLAD from the db scans) or the [i2i-train] zoo's."""
    if key == "i2i":
        with tempfile.TemporaryDirectory() as workdir:
            tr, _ = i2i_trainer(torch, cfg, ds, workdir, "cuda")
        model = tr.model
    else:
        model = training_model(torch, cfg, ds, "cuda")
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def dp_trainer(torch, key, cfg, ds, state, workdir, device, mesh=None):
    from gloc3d_tpu_torch.models.descriptor import build_model
    from gloc3d_tpu_torch.models.encoders import train_mask
    from gloc3d_tpu_torch.train import Trainer

    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(state)
    kw = ({"trainable_mask": train_mask(model, cfg.model.encoder)}
          if key == "i2i" else {})
    return Trainer(cfg, model, ds, workdir, device=device, mesh=mesh, **kw)


def dp_step(torch, tr, batch):
    """One train_step of ``tr`` on the fixed batch (the whole batch, on
    every rank), the step _train_batch takes after mining: on the
    host-stats path each rank rotates and bins its own rows on the host →
    (loss, {parameter: gradient} on the CPU, (K1, K2) launches)."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    reset_launches(ss.segment_sum_sorted, bs.pillar_bin_sums)
    loss = float(tr.train_step(*batch))
    launches = (launches_of(ss.segment_sum_sorted),
                launches_of(bs.pillar_bin_sums))
    grads = {k: p.grad.detach().cpu().clone()
             for k, p in tr.model.named_parameters() if p.grad is not None}
    return loss, grads, launches


def dp_step_ms(torch, tr, ds):
    """Host-clock ms of _train_batch (mining, gather, train_step: the
    rank's host pass if any, upload, forward, backward, gradient
    all-reduce, SGD) on queries 0-1 from one feature cache: median of
    DP_TIMED after a warm-up."""
    cache_db = tr.compute_cache(ds.db_inputs, ds.db_masks)
    cache_q = tr.compute_cache(ds.q_inputs, ds.q_masks)
    b = tr.cfg.train.batch_size
    times = []
    for i in range(DP_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(tr._train_batch(np.arange(b), cache_db, cache_q) is not None,
              "[dp] the timed batch took no step")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def dp_localizers(torch, cfg, world, cases, datasets, serve, i2i, device):
    """[dp]'s extractions → {case: (localizer, extract's arguments)}: the
    fp32 folded serving model (state ``serve``) on the located map's 16
    keyframes, host stats and all-device, and on the aligned map's 16
    (align_ground=True, all-device, seed 0); the i2i case's ResNet18 (state
    ``i2i``) on 16 of its 768² db images."""
    from gloc3d_tpu_torch.models.descriptor import build_model
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    def stack(scans):
        return (np.stack([k[0] for k in scans]),
                np.stack([k[1] for k in scans]))

    n = cfg.voxel.max_points
    scans = stack(located_world_scans(world, n)[0][1])
    tilted = stack(aligned_world_scans(world, n)[0][2])
    s2s_model = cfg.model.replace(fold_bn=True, compute_dtype="float32")
    images = datasets["i2i"].db_inputs[:N_KEYFRAMES]
    out = {}
    for key, c, model_cfg, state, args, kw in (
            ("host-stats", cfg, s2s_model, serve, scans,
             dict(host_stats=True)),
            ("all-device", cfg, s2s_model, serve, scans, {}),
            ("aligned", cfg, s2s_model, serve, tilted,
             dict(align_ground=True, seed=0)),
            ("i2i images", cases["i2i"], cases["i2i"].model, i2i,
             (images, None, np.zeros((len(images), 2), np.float32)), {})):
        model = build_model(model_cfg, c.voxel)
        model.load_state_dict(state)
        out[key] = (GlobalLocalizer(c, model, device=device, **kw), args)
    return out


def dp_extract(torch, loc, args) -> dict:
    """loc.extract(*args) → its descriptors, BEV images and ground
    transforms (aligned) on the CPU, the localizer's generator state after
    the call, the (K1, K2) launches of the call, and the host-clock ms of
    further calls (median of 3 after a warm-up)."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    def cpu(x):
        return x.float().cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    reset_launches(ss.segment_sum_sorted, bs.pillar_bin_sums)
    desc, bev, ground = loc.extract(*args)
    out = {"launches": (launches_of(ss.segment_sum_sorted),
                        launches_of(bs.pillar_bin_sums)),
           "desc": cpu(desc), "image": cpu(bev.image),
           "gen": loc._gen.get_state().numpy()}
    if ground is not None:
        out.update(ground_q=cpu(ground.transform.rotation),
                   ground_t=cpu(ground.transform.translation),
                   ground_valid=cpu(ground.valid))
    out["ms"] = host_ms(torch, lambda: loc.extract(*args), 3)
    return out


def dp_same_extraction(tag, got, want, ref: str = "desc") -> float:
    """The DP extraction against the unsharded call's: descriptors within
    1e-5 of ``want[ref]``, BEV images, ground transforms and the generator
    state after the call bit-equal. → the descriptors' largest difference
    from ``want[ref]``."""
    err = float(np.abs(got["desc"] - want[ref]).max())
    fields = set(want) - {"desc_ranks"}
    differ = [k for k in fields - {"desc", "ms", "launches"}
              if not np.array_equal(got[k], want[k])]
    check(err <= 1e-5 and not differ and set(got) == fields,
          f"{tag}: descriptors {err:.1e} from the unsharded call's; not "
          f"bit-equal: {differ}")
    return err


def dp_rank(rank: int, n: int, device, tmp: str) -> None:
    """One of [dp]'s two gloo ranks on the one card (parallel/launch.py):
    the three DP steps and the four DP extractions of phase_dp on the
    same inputs, rebuilt from the world's seed, and the weights the parent
    wrote; rank 0 writes the results."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.parallel.collectives import same_on_every_rank

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PipelineConfig.s2s()
    cases = dp_cases(cfg)
    world = make_world()
    datasets = dp_datasets(torch, cases, world)
    rec = {}
    mesh = dist.group.WORLD
    for key, c in cases.items():
        ds = datasets[key]
        state = torch.load(os.path.join(tmp, f"{key}.pt"))
        with tempfile.TemporaryDirectory() as workdir:
            tr = dp_trainer(torch, key, c, ds, state, workdir, device, mesh)
            loss, grads, launches = dp_step(
                torch, tr, dp_batch(torch, ds, c, key != "i2i"))
            flat = torch.cat([p.detach().reshape(-1)
                              for p in tr.model.parameters()])
            rec[f"{key}_same"] = same_on_every_rank(mesh, flat)
            rec[f"{key}_loss"], rec[f"{key}_launches"] = loss, launches
            for k, g in grads.items():
                rec[f"{key}_grad/{k}"] = g.numpy()
            rec[f"{key}_ms"] = dp_step_ms(torch, tr, ds)
            del tr
        torch.cuda.empty_cache()
    states = [torch.load(os.path.join(tmp, f"{k}.pt")) for k in ("serve",
                                                                  "i2i")]
    for key, (loc, args) in dp_localizers(torch, cfg, world, cases, datasets,
                                          *states, device).items():
        loc.shard_extraction(mesh)
        for k, v in dp_extract(torch, loc, args).items():
            rec[f"x_{key}/{k}"] = v
    if rank == 0:
        np.savez(os.path.join(tmp, "rank0.npz"), **rec)
    dist.barrier()


def grad_diff(torch, got, want):
    """The difference of two steps' gradients, all trainable tensors
    together, relative to ``want``'s norm; and the worst tensor's relative
    to its own norm, with its name."""
    diff = torch.cat([(got[k] - want[k]).reshape(-1) for k in want])
    ref = torch.cat([want[k].reshape(-1) for k in want])
    worst, name = max((float((got[k] - want[k]).norm() / want[k].norm()), k)
                      for k in want)
    return float(diff.norm() / ref.norm()), worst, name


def dp_grad_err(torch, tag, got, want):
    """The DP step's gradients against the unsharded step's: all together
    within DP_GRAD_TOL of their norm, and each tensor within DP_TENSOR_TOL
    of its own. → grad_diff's (together, worst tensor, its name)."""
    check(set(got) == set(want), f"{tag}: gradients of other parameters")
    err = grad_diff(torch, got, want)
    check(err[0] <= DP_GRAD_TOL and err[1] <= DP_TENSOR_TOL,
          f"{tag}: gradients {err[0]:.2e} of their norm from the unsharded "
          f"step's (bound {DP_GRAD_TOL}), worst tensor {err[2]} {err[1]:.2e}"
          f" of its own (bound {DP_TENSOR_TOL})")
    return err


def phase_dp(torch, card, cfg, world, centroids):
    """[dp]: data-parallel training and extraction on the card, at the
    shapes of the train phases (24 scans of 122 480 points or 24 ResNet18
    images at 768² a step) and of the located and aligned maps (16
    keyframes), in fp32 with TF32 off. World size 1 over NCCL in this
    process: one train_step (the step of _train_batch) of
    Trainer(mesh=group) on each case against the unsharded trainer's from
    the same weights on the same batch (loss rtol 1e-4, the gradients
    within DP_GRAD_TOL of their norm and DP_TENSOR_TOL per tensor, beside
    the unsharded step's own change on its batch reversed), and
    shard_extraction against the unsharded extract (descriptors 1e-5; BEV
    images, aligned ground transforms and the localizer's generator state
    bit-equal) on the host-stats, all-device, aligned and i2i-image
    paths. World size 2 over gloo, two spawned ranks on the one card: the
    same steps and extractions, the parameters bit-equal on both ranks.
    K1 / K2 launches of each, and host-clock ms of the step
    (_train_batch) and of the extraction beside the unsharded ones."""
    import torch.distributed as dist

    from gloc3d_tpu_torch.parallel.data import require_group
    from gloc3d_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    cases = dp_cases(cfg)
    datasets = dp_datasets(torch, cases, world)
    serve = build_serving_model(torch, cfg, "float32", centroids).state_dict()
    serve = {k: v.cpu() for k, v in serve.items()}
    rec = {"steps": {}, "extract": {}}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        want = {}
        for key, c in cases.items():
            ds = datasets[key]
            state = dp_initial_state(torch, key, c, ds)
            torch.save(state, os.path.join(tmp, f"{key}.pt"))
            with tempfile.TemporaryDirectory() as workdir:
                tr = dp_trainer(torch, key, c, ds, state, workdir, "cuda")
                want[key] = dp_step(torch, tr, dp_batch(torch, ds, c,
                                                        key != "i2i"))[:2]
                rec["steps"][key] = {"unsharded_ms": dp_step_ms(torch, tr,
                                                                ds)}
                tr = dp_trainer(torch, key, c, ds, state, workdir, "cuda")
                reversed_ = dp_step(torch, tr, dp_batch(
                    torch, ds, c, key != "i2i", reverse=True))[1]
                rec["steps"][key]["floor"] = grad_diff(
                    torch, reversed_, want[key][1])
                del tr
            torch.cuda.empty_cache()
        torch.save(serve, os.path.join(tmp, "serve.pt"))
        i2i = torch.load(os.path.join(tmp, "i2i.pt"))
        locs = dp_localizers(torch, cfg, world, cases, datasets, serve, i2i,
                             "cuda")
        plain = {key: dp_extract(torch, loc, args)
                 for key, (loc, args) in locs.items()}
        # cuDNN picks its convolution algorithms by batch size: ResNet18's
        # fp32 descriptors of 8 images differ from those of the same images
        # in a batch of 16 by ~1e-4, so a world-2 rank is held to the
        # unsharded call on its own 8 images
        loc, (images, _, origins) = locs["i2i images"]
        half = len(images) // 2
        plain["i2i images"]["desc_ranks"] = np.concatenate([
            loc.extract(images[i:i + half], None, origins[i:i + half])[0]
            .float().cpu().numpy() for i in (0, half)])
        del locs, loc

        # world size 1: NCCL in this process
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{free_port()}", world_size=1, rank=0)
        try:
            mesh = require_group(None, "[dp]")
            for key, c in cases.items():
                ds = datasets[key]
                state = torch.load(os.path.join(tmp, f"{key}.pt"))
                with tempfile.TemporaryDirectory() as workdir:
                    tr = dp_trainer(torch, key, c, ds, state, workdir,
                                    "cuda", mesh)
                    loss, grads, n_k = dp_step(
                        torch, tr, dp_batch(torch, ds, c, key != "i2i"))
                    check(abs(loss - want[key][0]) <= 1e-4 * abs(
                        want[key][0]), f"[dp] world 1 {key}: loss {loss} "
                          f"against the unsharded {want[key][0]}")
                    step = rec["steps"][key]
                    step["world1_grad_err"] = dp_grad_err(
                        torch, f"[dp] world 1 {key}", grads, want[key][1])
                    step["world1_loss"], step["unsharded_loss"] = (
                        loss, want[key][0])
                    step["world1_ms"] = dp_step_ms(torch, tr, ds)
                    launches[("step", 1, key)] = n_k
                    del tr
                torch.cuda.empty_cache()
            for key, (loc, args) in dp_localizers(
                    torch, cfg, world, cases, datasets, serve, i2i,
                    "cuda").items():
                loc.shard_extraction(mesh)
                got = dp_extract(torch, loc, args)
                err = dp_same_extraction(f"[dp] world 1 {key} extraction",
                                         got, plain[key])
                rec["extract"][key] = {"unsharded_ms": plain[key]["ms"],
                                       "world1_ms": got["ms"],
                                       "world1_err": err}
                launches[("extraction", 1, key)] = got["launches"]
        finally:
            dist.destroy_process_group()

        # world size 2: two gloo ranks spawned on the one card
        t0 = time.perf_counter()
        spawn(dp_rank, 2, "cuda", args=(tmp,))
        spawn_s = time.perf_counter() - t0
        two = dict(np.load(os.path.join(tmp, "rank0.npz")))
    for key in cases:
        check(bool(two[f"{key}_same"]),
              f"[dp] world 2 {key}: parameters differ across the ranks")
        loss = float(two[f"{key}_loss"])
        check(abs(loss - want[key][0]) <= 1e-4 * abs(want[key][0]),
              f"[dp] world 2 {key}: loss {loss} against {want[key][0]}")
        grads = {k[len(key) + 6:]: torch.from_numpy(v) for k, v in
                 two.items() if k.startswith(f"{key}_grad/")}
        step = rec["steps"][key]
        step["world2_grad_err"] = dp_grad_err(torch, f"[dp] world 2 {key}",
                                              grads, want[key][1])
        step["world2_loss"] = loss
        step["world2_ms"] = float(two[f"{key}_ms"])
        launches[("step", 2, key)] = tuple(
            int(x) for x in two[f"{key}_launches"])
    for key in plain:
        got = {k.split("/", 1)[1]: v for k, v in two.items()
               if k.startswith(f"x_{key}/")}
        ranks = "desc_ranks" in plain[key]
        err = dp_same_extraction(f"[dp] world 2 {key} extraction", got,
                                 plain[key],
                                 "desc_ranks" if ranks else "desc")
        rec["extract"][key].update(world2_ms=float(got["ms"]),
                                   world2_err=err)
        if ranks:
            rec["extract"][key]["world2_err_whole_batch"] = float(
                np.abs(got["desc"] - plain[key]["desc"]).max())
        launches[("extraction", 2, key)] = tuple(
            int(x) for x in got["launches"])
    for (what, n, key), (k1, k2) in launches.items():
        check(((k1 > 0), (k2 > 0)) == DP_KERNELS[key],
              f"[dp] {what} world {n}, {key}: launches K1 {k1}, K2 {k2}")
    rec["launches"] = {f"dp {what} world {n}{' (rank 0)' if n > 1 else ''}"
                       f", {key}": list(v)
                       for (what, n, key), v in launches.items()}
    rec["spawn_s"] = spawn_s
    for key, s in rec["steps"].items():
        w1, w2, fl = s["world1_grad_err"], s["world2_grad_err"], s["floor"]
        print(f"[dp] step {key} on {card}: unsharded {s['unsharded_ms']:.2f}"
              f", world 1 (NCCL) {s['world1_ms']:.2f}, world 2 (gloo, one "
              f"card) {s['world2_ms']:.2f} ms (host clock, _train_batch, "
              f"median of {DP_TIMED}); loss {s['unsharded_loss']:.6f} → "
              f"{s['world1_loss']:.6f} / {s['world2_loss']:.6f}; gradients "
              f"{w1[0]:.2e} / {w2[0]:.2e} of their norm (bound "
              f"{DP_GRAD_TOL}), worst tensor {w1[1]:.2e} / {w2[1]:.2e}, "
              f"{w2[2]} (bound {DP_TENSOR_TOL}); the unsharded step's own "
              f"change on its batch reversed {fl[0]:.2e}, worst tensor "
              f"{fl[1]:.2e} ({fl[2]}); world 2 parameters bit-equal on both "
              f"ranks")
    for key, s in rec["extract"].items():
        extra = (", ground transforms and generator state bit-equal"
                 if key == "aligned" else "")
        if "world2_err_whole_batch" in s:
            extra += (f" (world 2 against the unsharded call on each rank's "
                      f"{N_KEYFRAMES // 2} images; against the batch of "
                      f"{N_KEYFRAMES}: {s['world2_err_whole_batch']:.1e})")
        print(f"[dp] extraction {key}, {N_KEYFRAMES} inputs, on {card}: "
              f"unsharded {s['unsharded_ms']:.2f}, world 1 "
              f"{s['world1_ms']:.2f}, world 2 {s['world2_ms']:.2f} ms (host "
              f"clock, median of 3); descriptors within "
              f"{max(s['world1_err'], s['world2_err']):.1e}, BEV bit-equal"
              f"{extra}")
    print(f"[dp] launches (K1, K2): " + ", ".join(
        f"{k} {v}" for k, v in rec["launches"].items()))
    print(f"[dp] phase {time.perf_counter() - t_phase:.1f} s (world 2: "
          f"spawn to join {spawn_s:.1f} s)")
    return rec


DEVICE_CLASSES = (  # kernel-name fragment → class, first match wins
    ("segment_sum_sorted_kernel", "K1"), ("pillar_bin_sums", "K2"),
    ("xmma", "conv/matmul"), ("conv", "conv/matmul"), ("gemm", "conv/matmul"),
    ("cutlass", "conv/matmul"), ("cudnn", "conv/matmul"),
    ("index", "gather/index"), ("gather", "gather/index"),
    ("scatter", "gather/index"), ("batch_norm", "BN/reduce"),
    ("welford", "BN/reduce"), ("reduce", "BN/reduce"))


def device_time_by_class(events) -> dict:
    """Summed device ms of a chrome trace's kernels by DEVICE_CLASSES (other
    kernels: "elementwise/other"), plus copies and fills."""
    out: dict = {}
    for e in events:
        cat = e.get("cat")
        if cat in ("gpu_memcpy", "gpu_memset"):
            key = "memcpy/memset"
        elif cat == "kernel":
            name = e.get("name", "").lower()
            key = next((k for frag, k in DEVICE_CLASSES if frag in name),
                       "elementwise/other")
        else:
            continue
        out[key] = out.get(key, 0.0) + e.get("dur", 0) / 1e3
    return out


def trace_events(prof) -> list:
    """The chrome-trace events of a finished torch.profiler run."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def trace(torch, fn):
    """Trace fn() once with torch.profiler, after one untraced call: (the
    chrome-trace events, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return trace_events(prof), wall


def device_busy(events):
    """(device busy ms as the union of kernel / memcpy / memset intervals,
    number of kernels, device ms by class) of a trace's events."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    return busy / 1e3, n_kernels, device_time_by_class(events)


def device_idle_share(torch, fn):
    """Trace fn() once: (device busy ms, wall ms, number of kernels, device
    ms by class)."""
    events, wall = trace(torch, fn)
    busy, n_kernels, by_class = device_busy(events)
    return busy, wall, n_kernels, by_class


def phase_aligned_timing(torch, cfg, loc, qs, card):
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev
    from gloc3d_tpu_torch.ops.topk import l2_topk

    pts, mask = qs[0]
    detect = host_ms(torch, lambda: loc.detect(pts[None], mask[None]), 10)
    locate = host_ms(torch, lambda: [loc.locate(*q) for q in qs], 3) / len(qs)
    print(f"[timing-aligned] all-device aligned path on {card}: detect "
          f"{detect:.3f} ms (host clock, median of 10; {len(loc.bank)}-row "
          f"bank), locate {locate:.3f} ms per query (host clock, "
          f"{len(qs)} queries x 3, staged first)")

    p_d = torch.from_numpy(pts[None]).cuda()
    m_d = torch.from_numpy(mask[None]).cuda()
    with torch.no_grad():
        ground = cuda_ms(torch, lambda: loc._align(p_d, m_d), 10)
        aligned, _ = loc._align(p_d, m_d)
        bev_ms = cuda_ms(torch, lambda: batch_scan_to_bev(
            aligned[..., :3], m_d, cfg.bev), 10)
        calls = record_launches(lambda: loc.model(aligned, m_d))["K2"]
        k2 = [cuda_ms(torch, lambda: bs.pillar_bin_sums(*c), 20)
              for c in calls]
        fwd = cuda_ms(torch, lambda: loc.model(aligned, m_d), 10)
        desc = loc.model(aligned, m_d)
        topk = cuda_ms(torch, lambda: l2_topk(desc, loc.bank.data,
                                              cfg.index.top_k), 10)
        bev = batch_scan_to_bev(aligned[..., :3], m_d, cfg.bev)
    reg = cuda_ms(torch, lambda: loc._match(bev.image[:1], bev.origin_xy[:1],
                                            np.zeros((1, 1), np.int64)), 5)
    print(f"[timing-aligned] stages of one scan on {card} (CUDA events "
          f"around each call, host gaps included): ground estimate + "
          f"alignment {ground:.3f} ms; device BEV {bev_ms:.3f} ms; K2 "
          f"statistics {k2[0]:.3f} ms, K2 features {k2[1]:.3f} ms (wrapper, "
          f"id check included); descriptor forward incl. both K2 "
          f"{fwd:.3f} ms; top-{cfg.index.top_k} {topk:.3f} ms; registration "
          f"K=1 {reg:.3f} ms")
    busy, wall, n_k, _ = device_idle_share(torch, lambda: loc.locate(*qs[1]))
    print(f"[timing-aligned] traced aligned locate on {card}: device busy "
          f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
          f"{1 - busy / wall:.3f}, {n_k} kernels (torch.profiler; against "
          f"the untraced {locate:.3f} ms per query the idle share is "
          f"{1 - busy / locate:.3f})")


def phase_timing(torch, cfg, loc, kf, qs, card):
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.ops.topk import l2_topk
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    n = cfg.voxel.max_points
    pts, mask = bench_query_scan(n)
    bank_rows = np.random.RandomState(0).randn(10000, cfg.index.dim).astype(
        np.float32)
    det = GlobalLocalizer(cfg, loc.model, device=torch.device("cuda"),
                          host_stats=True)
    det.bank.add(bank_rows)
    detect = host_ms(torch, lambda: det.detect(pts, mask), 20)
    # the plain all-device path (the default), same weights and bank
    det_dev = GlobalLocalizer(cfg, loc.model, device=torch.device("cuda"))
    det_dev.bank.add(bank_rows)
    detect_dev = host_ms(torch, lambda: det_dev.detect(pts, mask), 20)

    # host half (stats + sort + BEV) and device half (forward + top-20)
    vc = cfg.voxel
    counts = np.asarray(mask.sum(axis=1), np.int64)
    t0 = time.perf_counter()
    for _ in range(5):
        host = native.compute_voxel_stats_host_sorted(
            pts, counts, vc.xbound, vc.ybound, vc.zbound, crop=False,
            per_point=True)
        native.compute_bev_host(pts, counts, cfg.bev)
    host_pass = (time.perf_counter() - t0) / 5 * 1e3
    d = [torch.from_numpy(a).cuda() for a in host]
    bank = det.bank.data

    def fwd_topk():
        with torch.no_grad():
            desc = det.model(d[0], d[1], voxel_stats=tuple(d[2:]))
            return l2_topk(desc, bank, cfg.index.top_k)

    dev_detect = cuda_ms(torch, fwd_topk, 20)
    print(f"[timing] detect at bench.py's shape (122480-point pad, 10000 x "
          f"{cfg.index.dim} bank, top-{cfg.index.top_k}) on {card}: "
          f"end to end {detect:.3f} ms (host clock, median of 20); host "
          f"stats + BEV pass {host_pass:.3f} ms; device forward + top-k "
          f"{dev_detect:.3f} ms (CUDA events); all-device detect "
          f"(host_stats=False) {detect_dev:.3f} ms (host clock, median of 20)")

    loc_dev = build_map(torch, cfg, loc.model, kf)
    locate_dev = host_ms(torch, lambda: [loc_dev.locate(*q) for q in qs],
                         3) / len(qs)
    locate = host_ms(torch, lambda: [loc.locate(*q) for q in qs], 3) / len(qs)
    _, _, bev, _ = loc.detect(qs[0][0][None], qs[0][1][None])
    rows = np.arange(cfg.index.top_k) % len(loc.keyframes)
    m1 = cuda_ms(torch, lambda: loc._match(bev.image[:1], bev.origin_xy[:1],
                                           rows[None, :1]), 5)
    mk = cuda_ms(torch, lambda: loc._match(bev.image[:1], bev.origin_xy[:1],
                                           rows[None]), 3)
    print(f"[timing] located query (16 keyframes, staged first) on {card}: "
          f"{locate:.3f} ms per query (host clock, {len(qs)} queries x 3); "
          f"registration K=1 {m1:.3f} ms, K={cfg.index.top_k} {mk:.3f} ms "
          f"(CUDA events around the call: candidate upload and host gaps "
          f"included); all-device located query (host_stats=False, "
          f"align_ground=False) {locate_dev:.3f} ms per query (host clock, "
          f"same queries x 3)")


# ------------------------------------------------------------------- i2i
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16, NVIDIA data sheet


def i2i_model(torch, cfg, dtype: str, centroids=None, alpha: float = 30.0,
              device="cuda"):
    """The port's seeded VGG16 + NetVLAD-FC in ``dtype`` on ``device``,
    NetVLAD given ``centroids`` (assignment weights alpha·centroids) where
    given."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params

    model = init_params(build_model(
        cfg.model.replace(compute_dtype=dtype), cfg.voxel), seed=0)
    if centroids is not None:
        with torch.no_grad():
            model.pool.centroids.copy_(centroids)
            model.pool.conv.weight.copy_(alpha * centroids[:, :, None, None])
    return model.to(device).eval()


def i2i_centroids(torch, cfg, kf_set, seed=0):
    """NetVLAD's data init for the i2i phases: K normalised local features
    of the seeded fp32 VGG16, sampled from the feature maps of the aligned
    map's db BEVs (as vlad_centroids does for PointPillar)."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    model = i2i_model(torch, cfg, "float32")
    loc = GlobalLocalizer(cfg, model, device=torch.device("cuda"),
                          align_ground=True)
    feats = []
    with torch.no_grad():
        for i in range(0, len(kf_set[2]), 4):
            kf = kf_set[2][i:i + 4]
            _, bev, _ = loc.extract(np.stack([k[0] for k in kf]),
                                    np.stack([k[1] for k in kf]))
            feats.append(model.encode(bev.image[..., None].repeat(1, 1, 1, 3)))
    f = torch.nn.functional.normalize(
        torch.cat(feats).reshape(-1, cfg.model.encoder_dim).float(),
        dim=-1).cpu()
    pick = torch.randperm(f.shape[0], generator=torch.Generator(
    ).manual_seed(seed))[: cfg.model.num_clusters]
    return f[pick]


def render_bevs(torch, cfg, scans):
    """Scans → their BEV images as the i2i inputs a user loads from disk:
    ((B, S, S, 3) float32 numpy, free = 1.0; (B, 2) origins), projected by
    the port on the card."""
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev

    images, origins = [], []
    for i in range(0, len(scans), 4):
        pts = torch.from_numpy(np.stack([s[0] for s in scans[i:i + 4]]))
        mask = torch.from_numpy(np.stack([s[1] for s in scans[i:i + 4]]))
        bev = batch_scan_to_bev(pts[..., :3].cuda(), mask.cuda(), cfg.bev)
        images.append(bev.image[..., None].repeat(1, 1, 1, 3).cpu().numpy())
        origins.append(bev.origin_xy.cpu().numpy())
    return np.concatenate(images), np.concatenate(origins)


def top_kernels(events, n: int = 4) -> str:
    """The n kernels of a trace with the most device time, summed by
    name."""
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top)


def phase_i2i_cell(torch, cfg, model, card):
    """bench.py's i2i shape: one (1, 768, 768, 3) image (rand > 0.01), a
    random (10 000, 512) bank, detect = forward + top-20; B=1 and B=8."""
    from gloc3d_tpu_torch.models.vgg import conv_flops
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    s = cfg.bev.image_size
    rng = np.random.RandomState(0)
    img1 = (rng.rand(1, s, s, 3) > 0.01).astype(np.float32)
    img8 = np.repeat(img1, 8, axis=0)
    det = GlobalLocalizer(cfg, model, device=torch.device("cuda"))
    det.bank.add(rng.randn(10000, cfg.index.dim).astype(np.float32))
    d1, i1, _, _ = det.detect(img1)
    d8, i8, _, _ = det.detect(img8)
    check(i1.shape == (1, cfg.index.top_k) and np.isfinite(d1).all(),
          "i2i detect output")
    check(bool((i8 == i1).all()), "i2i detect at B=8 differs from B=1")

    b1 = cuda_ms(torch, lambda: det.detect(img1), 20)
    b8 = cuda_ms(torch, lambda: det.detect(img8), 10) / 8
    h1 = host_ms(torch, lambda: det.detect(img1), 20)
    x1, x8 = torch.from_numpy(img1).cuda(), torch.from_numpy(img8).cuda()
    with torch.no_grad():
        enc1 = cuda_ms(torch, lambda: det.model.encode(x1), 20)
        enc8 = cuda_ms(torch, lambda: det.model.encode(x8), 10) / 8
        fwd1 = cuda_ms(torch, lambda: det.model(x1), 20)
    flops = conv_flops(1, s)
    mfu1 = flops / (enc1 * 1e-3) / BF16_FLOPS_PER_S
    mfu8 = flops / (enc8 * 1e-3) / BF16_FLOPS_PER_S
    bound = flops / BF16_FLOPS_PER_S * 1e3
    print(f"[i2i-cell] detect at bench.py's i2i shape (VGG16 + NetVLAD-FC "
          f"bf16, {s}² image, 10000 x {cfg.index.dim} bank, top-"
          f"{cfg.index.top_k}) on {card}: {b1:.3f} ms per query at B=1, "
          f"{b8:.3f} ms per query at B=8 (CUDA events around 20 / 10 "
          f"detects, mean; image upload included); host clock {h1:.3f} ms at "
          f"B=1 (median of 20)")
    print(f"[i2i-cell] VGG16 forward on an image on the card: "
          f"{flops / 1e9:.1f} GFLOP per image (13 convs, from their shapes), "
          f"bound {bound:.4f} ms at 989 TFLOP/s dense bf16; conv stack "
          f"{enc1:.3f} ms at B=1 ({flops / enc1 / 1e9:.1f} TFLOP/s, "
          f"i2i_forward_mfu={mfu1:.4f}), {enc8:.3f} ms per image at B=8 "
          f"({flops / enc8 / 1e9:.1f} TFLOP/s, share {mfu8:.4f}); with "
          f"NetVLAD-FC {fwd1:.3f} ms at B=1 (CUDA events, mean of 20 "
          f"back-to-back calls at B=1, 10 at B=8)")
    events, wall = trace(torch, lambda: det.detect(img1))
    busy, n_k, by_class = device_busy(events)
    print(f"[i2i-cell] traced detect at B=1: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall, {n_k} kernels; device ms by class: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              by_class.items(), key=lambda kv: -kv[1]))
          + f"; top kernels: {top_kernels(events)}")
    return {"i2i_forward_mfu": mfu1, "forward_ms": enc1,
            "detect_ms_b1": b1, "detect_ms_b8": b8}


def phase_i2i_aligned(torch, cfg, model, kf_set, q_set, card):
    """The paper's configuration: aligned scan → BEV → VGG16 → 6-DoF, on
    the tilted world of phase 6, held to its gates."""
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev
    from gloc3d_tpu_torch.ops.topk import l2_topk

    qs = q_set[2]
    loc, results = run_aligned(torch, cfg, model, kf_set[2], qs,
                               host_stats=False)
    check_aligned(torch, "i2i-aligned", results, kf_set, q_set)
    locate = host_ms(torch, lambda: [loc.locate(*q) for q in qs], 3) / len(qs)
    pts, mask = qs[0]
    p_d = torch.from_numpy(pts[None]).cuda()
    m_d = torch.from_numpy(mask[None]).cuda()
    with torch.no_grad():
        ground = cuda_ms(torch, lambda: loc._align(p_d, m_d), 10)
        aligned, _ = loc._align(p_d, m_d)
        bev_ms = cuda_ms(torch, lambda: batch_scan_to_bev(
            aligned[..., :3], m_d, cfg.bev), 10)
        bev = batch_scan_to_bev(aligned[..., :3], m_d, cfg.bev)
        img = bev.image[..., None].repeat(1, 1, 1, 3)
        fwd = cuda_ms(torch, lambda: loc.model(img), 10)
        desc = loc.model(img)
        topk = cuda_ms(torch, lambda: l2_topk(desc, loc.bank.data,
                                              cfg.index.top_k), 10)
    reg = cuda_ms(torch, lambda: loc._match(bev.image[:1], bev.origin_xy[:1],
                                            np.zeros((1, 1), np.int64)), 5)
    busy, wall, n_k, by_class = device_idle_share(
        torch, lambda: loc.locate(*qs[1]))
    print(f"[i2i-aligned] aligned i2i locate ({len(kf_set[2])} keyframes, "
          f"staged first, default matcher) on {card}: {locate:.3f} ms per "
          f"query (host clock, {len(qs)} queries x 3); stages of one scan "
          f"(CUDA events around each call): ground estimate + alignment "
          f"{ground:.3f} ms, device BEV {bev_ms:.3f} ms, VGG16 + NetVLAD-FC "
          f"forward {fwd:.3f} ms, top-{cfg.index.top_k} {topk:.3f} ms, "
          f"registration K=1 {reg:.3f} ms")
    print(f"[i2i-aligned] traced aligned i2i locate: device busy "
          f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
          f"{1 - busy / wall:.3f}, {n_k} kernels (against the untraced "
          f"{locate:.3f} ms the idle share is {1 - busy / locate:.3f}); "
          f"device ms by class: " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(by_class.items(),
                                                key=lambda kv: -kv[1])))
    return locate


def phase_i2i_fused(torch, cfg, centroids, lq_set, card):
    """Image inputs on the serving configuration: the located world's db
    BEVs as (B, S, S, 3) images with their origins, fast_match(fm=True),
    the device store without a host mirror, image queries. The bf16 map is
    held to the located gates and locate = locate_fused; locate =
    locate_batch = locate_fused on the fp32 map (a batch of 8 may take
    other conv kernels than a batch of 1, and bf16 rounding then reorders
    nearly tied keyframes)."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    (kf_poses, kf), (q_poses, qs) = lq_set
    kf_img, kf_org = render_bevs(torch, cfg, kf)
    q_img, q_org = render_bevs(torch, cfg, qs)

    def serving(model):
        loc = GlobalLocalizer(cfg.fast_match(fm=True), model,
                              device=torch.device("cuda"),
                              device_keyframes=True, host_mirror=False)
        for i in range(0, len(kf_img), 4):
            loc.add_keyframes(kf_img[i:i + 4], origins=kf_org[i:i + 4])
        return loc

    loc = serving(i2i_model(torch, cfg, "bfloat16", centroids))
    check(all(k.image is None for k in loc.keyframes),
          "host_mirror=False kept images on the host")
    fused = [loc.locate_fused(i, origin=o) for i, o in zip(q_img, q_org)]
    check_located("i2i-fused", fused, kf_poses, q_poses, cfg.index.top_k)
    d0 = same_results("i2i bf16 locate vs locate_fused",
                         [loc.locate(i, origin=o)
                          for i, o in zip(q_img, q_org)], fused)
    loc32 = serving(i2i_model(torch, cfg, "float32", centroids))
    r_loc = [loc32.locate(i, origin=o) for i, o in zip(q_img, q_org)]
    r_batch = loc32.locate_batch(q_img, origins=q_org)
    r_fused = [loc32.locate_fused(i, origin=o) for i, o in zip(q_img, q_org)]
    d1 = same_results("i2i fp32 locate vs locate_batch", r_loc, r_batch)
    d2 = same_results("i2i fp32 locate vs locate_fused", r_loc, r_fused)
    print(f"[i2i-fused] locate = locate_fused on the bf16 map (max |diff| "
          f"{d0:.2e}); fp32 map: locate = locate_batch = locate_fused for "
          f"{len(qs)}/{len(qs)} queries ({sum(r.success for r in r_loc)} "
          f"localized; same db_index and candidates, ranked), xy_yaw max "
          f"|diff| {d1:.2e} / {d2:.2e} (bound 1e-4)")

    img, org = q_img[0], q_org[0]

    def fused_call():
        return loc.locate_fused(img, origin=org)

    def plain_call():
        return loc.locate(img, origin=org)

    t = [host_ms(torch, f, 10) for f in (fused_call, plain_call, plain_call,
                                         fused_call)]
    syncs = (count_syncs(torch, plain_call), count_syncs(torch, fused_call))
    busy, wall, n_k, _ = device_idle_share(torch, fused_call)
    print(f"[i2i-fused] image query, fm preset, bf16, {len(kf_img)}-keyframe "
          f"store on {card}: locate_fused {t[0]:.3f} / {t[3]:.3f} ms per "
          f"query, locate {t[1]:.3f} / {t[2]:.3f} ms (host clock, median of "
          f"10 each, in the order fused, locate, locate, fused); host syncs "
          f"per call (set_sync_debug_mode): locate {syncs[0]}, locate_fused "
          f"{syncs[1]}; traced locate_fused: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall, {n_k} kernels")
    return t[0]


def phase_i2i_reference(torch, cfg, kf_set, q_set, centroids):
    """Card against CPU, fp32 with TF32 off in both cuDNN and matmul: one
    768² forward (a real BEV of the aligned map), and one aligned i2i
    located query with the same draws."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    img, _ = render_bevs(torch, cfg, q_set[2][:1])
    out = {}
    for dev in ("cuda", "cpu"):
        model = i2i_model(torch, cfg, "float32", centroids, device=dev)
        with torch.no_grad():
            feat = model.encode(torch.from_numpy(img).to(dev))
            out[dev] = (feat.cpu().double(), model.pool(feat).cpu().double())
    (f_g, d_g), (f_c, d_c) = out["cuda"], out["cpu"]
    rel_f = float((f_g - f_c).norm() / f_c.norm())
    rel_d = float((d_g - d_c).norm() / d_c.norm())
    print(f"[i2i-reference] fp32 {img.shape[1]}² forward card vs CPU (TF32 "
          f"off in cuDNN and matmul): relative L2 error of the VGG16 feature "
          f"map {rel_f:.3e}, of the descriptor {rel_d:.3e} (limit 1e-3)")
    check(rel_d < 1e-3 and rel_f < 1e-3,
          "card i2i forward disagrees with the CPU")

    res = {}
    for dev in ("cuda", "cpu"):
        model = i2i_model(torch, cfg, "float32", centroids, device=dev)
        loc, _ = run_aligned(torch, cfg, model, kf_set[2][:2], [],
                             host_stats=False, seed=5, device=dev)
        res[dev] = loc.locate(*q_set[2][0])
    a, b = res["cuda"], res["cpu"]
    check(a.success and a.success == b.success and a.db_index == b.db_index,
          f"card aligned i2i locate (success {a.success}, db {a.db_index}) "
          f"!= CPU (success {b.success}, db {b.db_index})")
    dt = float(np.abs(a.pose.translation - b.pose.translation).max())
    print(f"[i2i-reference] aligned i2i locate card vs CPU: db "
          f"{a.db_index}/{b.db_index}, pose translation max |diff| "
          f"{dt:.2e} m (bound 1e-3 m)")
    check(dt < 1e-3, f"card aligned i2i pose differs by {dt:.3e} m")


def run_i2i(torch, kf_set, q_set, lq_set, card):
    """The four i2i phases at PipelineConfig.i2i() (VGG16, 64 clusters x
    512, FC 32 768 → 512, bf16, 768² BEV)."""
    from gloc3d_tpu_torch import PipelineConfig

    cfg = PipelineConfig.i2i()
    centroids = i2i_centroids(torch, cfg, kf_set)
    model = i2i_model(torch, cfg, "bfloat16", centroids)
    out = phase_i2i_cell(torch, cfg, model, card)
    out["aligned_locate_ms"] = phase_i2i_aligned(torch, cfg, model, kf_set,
                                                 q_set, card)
    out["fused_ms"] = phase_i2i_fused(torch, cfg, centroids, lq_set, card)
    phase_i2i_reference(torch, cfg, kf_set, q_set, centroids)
    return out


# -------------------------------------------------------------- refinement
def refine_cfg(cfg):
    """``cfg`` with the ICP polish at the issue's full-width settings:
    4096-point clouds, 10 iterations, a 1 m gate."""
    return cfg.replace(match=cfg.match.replace(
        refine_icp=True, refine_icp_points=4096, refine_icp_iters=10,
        refine_icp_max_corr=1.0))


def located_errors(results, kf_poses, q_poses):
    """Planar position error of each result against the ground truth
    relative to the keyframe it returns."""
    return [float(np.linalg.norm(r.pose.translation[:2] - relative_pose(
        kf_poses[r.db_index], qp)[0])) for r, qp in zip(results, q_poses)]


def aligned_errors(torch, results, kf_set, q_set):
    """6-DoF position error of each aligned result."""
    from gloc3d_tpu_torch.eval.registration import registration_errors

    (kf_poses, kf_att, _), (q_poses, q_att, _) = kf_set, q_set
    return [float(registration_errors(r.pose, pose6(
        torch, kf_poses[r.db_index], kf_att[r.db_index]).inverse().compose(
        pose6(torch, qp, qa)))[0])
        for r, qp, qa in zip(results, q_poses, q_att)]


def check_tightens(tag, plain, refined):
    print(f"[{tag}] mean position error refined {np.mean(refined):.4f} m "
          f"against unrefined {np.mean(plain):.4f} m (worst "
          f"{max(refined):.4f} / {max(plain):.4f})")
    check(np.mean(refined) <= np.mean(plain),
          f"{tag}: the ICP polish raised the mean position error")


def xy_yaw_diff(a, b) -> float:
    """Largest of |Δdx|, |Δdy| (m) and |Δyaw| (rad, wrapped)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(max(np.abs(d[:2]).max(),
                     abs(math.remainder(float(d[2]), 2 * math.pi))))


def phase_refine_polish(torch, cfg, lq_set, centroids):
    """(a) on the host-stats located world, fp32 serving model: the ICP
    polish through locate on the host mirror (16 keyframes, 8 queries) at
    the located gates and against the unrefined map's errors; locate =
    locate_batch; match_keyframe on the mirror and on the device store (no
    mirror) = locate for the keyframe locate returns. Returns K1's
    launches on the refined map's build and queries."""
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    (kf_poses, kf), (q_poses, qs) = lq_set
    rcfg = refine_cfg(cfg)
    model = build_serving_model(torch, cfg, "float32", centroids)
    plain = build_map(torch, cfg, model, kf, host_stats=True)
    plain_res = [plain.locate(*q) for q in qs]
    reset_launches(ss.segment_sum_sorted)
    mirror = build_map(torch, rcfg, model, kf, host_stats=True)
    results = [mirror.locate(*q) for q in qs]
    k1 = launches_of(ss.segment_sum_sorted)
    print(f"[refine] host stats, fp32: {len(kf)} keyframes with "
          f"{mirror.keyframes[0].cloud.shape[0]}-point clouds, "
          f"{len(qs)} queries; K1 launches {k1}")
    check(k1 >= N_KEYFRAMES // 4 + N_QUERIES, f"K1 launched {k1} times")
    check_located("refine", results, kf_poses, q_poses, cfg.index.top_k)
    check_tightens("refine", located_errors(plain_res, kf_poses, q_poses),
                   located_errors(results, kf_poses, q_poses))

    batch = mirror.locate_batch(np.stack([q[0] for q in qs]),
                                np.stack([q[1] for q in qs]))
    worst = 0.0
    for i, (a, b) in enumerate(zip(batch, results)):
        check(a.success and a.db_index == b.db_index,
              f"refine locate_batch query {i}: db {a.db_index} vs "
              f"{b.db_index}")
        worst = max(worst, xy_yaw_diff(a.match_xy_yaw, b.match_xy_yaw))
    print(f"[refine] locate_batch = locate: same keyframe for {len(qs)}/"
          f"{len(qs)}, (dx, dy, yaw) within {worst:.2e} (bound 1e-4)")
    check(worst <= 1e-4, "refined locate_batch != locate")

    store = build_map(torch, rcfg, model, kf, host_stats=True,
                      device_keyframes=True, host_mirror=False)
    worst = {"mirror": 0.0, "store": 0.0}
    for i, (q, r) in enumerate(zip(qs, results)):
        for name, loc in (("mirror", mirror), ("store", store)):
            m = loc.match_keyframe(*q, db_index=r.db_index)
            check(m.success and m.db_index == r.db_index
                  and list(m.candidates) == [r.db_index],
                  f"match_keyframe ({name}) query {i} failed")
            worst[name] = max(worst[name], xy_yaw_diff(m.match_xy_yaw,
                                                       r.match_xy_yaw))
    print(f"[refine] match_keyframe = locate on the keyframe locate "
          f"returns: host mirror within {worst['mirror']:.2e}, device store "
          f"within {worst['store']:.2e} (bound 1e-4)")
    check(max(worst.values()) <= 1e-4, "match_keyframe != locate")
    times = {name: host_ms(torch, lambda: loc.locate(*qs[0]), 5)
             for name, loc in (("plain", plain), ("refined", mirror))}
    syncs = {name: count_syncs(torch, lambda: loc.locate(*qs[0]))
             for name, loc in (("plain", plain), ("refined", mirror))}
    print(f"[refine] locate, host stats, fp32: {times['refined']:.3f} ms "
          f"with the polish against {times['plain']:.3f} ms without "
          f"(median of 5, host clock); {syncs['refined']} host syncs "
          f"against {syncs['plain']}")
    return k1, times


def phase_refine_aligned(torch, cfg, model, kf_set, q_set, plain_results):
    """(a) on the aligned all-device map (bf16 serving model, the map and
    queries of the aligned phase): 6-DoF gates and the mean 6-DoF position
    error against the aligned phase's unrefined results. Returns K2's
    launches."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    reset_launches(bs.pillar_bin_sums)
    loc, results = run_aligned(torch, refine_cfg(cfg), model, kf_set[2],
                               q_set[2], host_stats=False)
    k2 = launches_of(bs.pillar_bin_sums)
    need = 2 * (len(kf_set[2]) // 4 + len(q_set[2]))
    print(f"[refine-aligned] clouds in the ground frame; K2 launches {k2} "
          f"(at least {need})")
    check(k2 >= need, f"K2 launched {k2} times, < {need}")
    check_aligned(torch, "refine-aligned", results, kf_set, q_set)
    check_tightens("refine-aligned",
                   aligned_errors(torch, plain_results, kf_set, q_set),
                   aligned_errors(torch, results, kf_set, q_set))
    return k2


def phase_refine_reference(torch, cfg, lq_set, centroids,
                           devices=("cuda", "cpu")):
    """One refined query card vs CPU (fp32, TF32 off, 2 keyframes): same
    success and keyframe, the polished (dx, dy, yaw) within one 0.2 m cell
    (the unrefined seed may differ by one, phase_reference); then the ICP
    alone on the same clouds from the same seed, 0.36 m and 1.1° off the
    polished match, within 1e-2 (a twentieth of a BEV cell): ten steps
    from that seed have not converged, and a nearest neighbour that the
    two devices' summation orders pick differently moves the rest of the
    walk (the first card run read 1.1e-3)."""
    (_, kf), (_, qs) = lq_set
    locs = [build_map(torch, refine_cfg(cfg), build_serving_model(
        torch, cfg, "float32", centroids), kf[:2], host_stats=True,
        device=dev) for dev in devices]
    a, b = (loc.locate(*qs[0]) for loc in locs)
    check(a.success and a.success == b.success
          and a.db_index == b.db_index, "card refined locate != CPU")
    err = xy_yaw_diff(a.match_xy_yaw, b.match_xy_yaw)
    q_cloud, q_valid = locs[1]._query_clouds(qs[0][0][None], qs[0][1][None],
                                             None)
    kc = locs[1].keyframes[b.db_index].cloud
    seed = np.asarray(b.match_xy_yaw) + np.array([0.3, -0.2, 0.02],
                                                 np.float32)
    icp = [loc._refine_icp(q_cloud[0], q_valid[0], kc[:, :3], kc[:, 3],
                           seed) for loc in locs]
    icp_err = xy_yaw_diff(*icp)
    print(f"[refine-reference] card vs CPU: db {a.db_index}/{b.db_index}, "
          f"polished (dx, dy, yaw) within {err:.2e} (bound 0.2 m); ICP "
          f"alone on the same clouds and seed within {icp_err:.2e} (bound "
          f"1e-2), {seed - icp[0]} from the seed")
    check(err <= 0.2 + 1e-3, "card refined pose disagrees with the CPU")
    check(icp_err <= 1e-2, "card ICP disagrees with the CPU ICP")


def phase_refine_slam(torch):
    """(b) the port's SLAM example at the JAX example's size on the card
    (run raises when lap 1 verifies a closure or lap 2 misses its gates)."""
    from gloc3d_tpu_torch.examples import slam_session
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    reset_launches(bs.pillar_bin_sums)
    t0 = time.perf_counter()
    out = slam_session.run(device="cuda",
                           log=lambda m: print(f"[refine-slam] {m}"))
    out["seconds"] = time.perf_counter() - t0
    out["k2_launches"] = launches_of(bs.pillar_bin_sums)
    print(f"[refine-slam] {out['closures']}/{out['lap']} closures, worst "
          f"{out['max_pos_err_m']:.3f} m / {out['max_yaw_err_deg']:.2f} deg "
          f"(gates 1 m / 5 deg); {out['seconds']:.1f} s; K2 launches "
          f"{out['k2_launches']}")
    check(out["closures"] >= 0.8 * out["lap"], "SLAM closures")
    return out


def refine_row(torch, card, name, make, compare, iters: int):
    """One refiner at its bench shape: ``make(device)`` → a call returning
    its outputs. CUDA-event ms (mean of ``iters`` after three), a traced
    call's device busy ms, idle share and kernel count, host syncs per
    call, and card vs CPU on the same inputs: ``compare(card, cpu)`` →
    [(label, error, bound)]."""
    fn = make("cuda")
    ms = cuda_ms(torch, fn, iters)
    busy, wall, n_kernels, _ = device_idle_share(torch, fn)
    syncs = count_syncs(torch, fn)
    got = fn()
    torch.cuda.synchronize()
    want = make("cpu")()
    rows = compare(got, want)
    agree = "; ".join(f"{label} {err:.2e} (bound {bound:g})"
                      for label, err, bound in rows)
    print(f"[refine-ops] {name} on {card}: {ms:.3f} ms (CUDA events, mean "
          f"of {iters}); traced: busy {busy:.3f} ms of {wall:.3f} ms, idle "
          f"{1.0 - busy / wall:.3f}, {n_kernels} kernels; {syncs} host "
          f"syncs per call; card vs CPU: {agree}")
    for label, err, bound in rows:
        check(err <= bound, f"{name}: card vs CPU {label} {err:.2e} > "
              f"{bound:g}")
    return {"ms": ms, "busy_ms": busy, "traced_wall_ms": wall,
            "idle_share": 1.0 - busy / wall, "kernels": n_kernels,
            "host_syncs": syncs,
            "card_vs_cpu": {label: [err, bound] for label, err, bound
                            in rows}}


def phase_refine_ops(torch, card, wall_scan):
    """(c) tools/bench_refine.py's five rows at its shapes, on bench.py's
    synthetic scan (100 000 points in a 131 072 pad) and a copy moved by
    (1.2, -0.8, 0.3) m and 0.15 rad, and contour_virtual_cloud on the 768²
    BEV of ``wall_scan`` (a located-world keyframe) with its occupancy
    dilated by a 5×5 window: its walls are one pixel thick, which the
    3×3 erosion would remove whole, and bench.py's uniform scan leaves
    isolated pixels; each beside the same call on the CPU."""
    import torch.nn.functional as F

    from gloc3d_tpu_torch import BEVConfig, MatchConfig
    from gloc3d_tpu_torch.core.transforms import Rigid3, quat_identity
    from gloc3d_tpu_torch.ops import contour, refine
    from gloc3d_tpu_torch.ops.bev import scan_to_bev

    bcfg = BEVConfig(image_size=768)
    pts, mask = (a[0] for a in bench_query_scan(bcfg.max_points))
    pts3 = pts[:, :3].copy()
    yaw = 0.15
    c, s = math.cos(yaw), math.sin(yaw)
    dst3 = pts3.copy()
    dst3[:, 0] = c * pts3[:, 0] - s * pts3[:, 1] + 1.2
    dst3[:, 1] = s * pts3[:, 0] + c * pts3[:, 1] - 0.8
    dst3[:, 2] += 0.3
    sel = np.random.RandomState(0).choice(100000, 4096, replace=False)
    dims, origin = (100, 100, 12), (-50.0, -50.0, -4.0)
    mcfg = MatchConfig(image_size=768, fine_downsample=2,
                       coarse_rot_downsample=8, fine_top_f=4,
                       fine_argmax_downsample=2, coarse_mode="fm")

    def on(dev, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def bevs(dev):
        p, d, m = on(dev, pts3, dst3, mask)
        return scan_to_bev(p, m, bcfg), scan_to_bev(d, m, bcfg)

    out = {}

    def icp(dev):
        src, dst = on(dev, pts3[sel], dst3[sel])
        ones = torch.ones(4096, device=dev)
        init = Rigid3(quat_identity(device=dev), torch.zeros(3, device=dev))
        return lambda: refine.icp_point_to_point(
            src, ones, dst, ones, init, iterations=20, max_corr_dist=2.0)

    def icp_cmp(a, b):
        dq = min(float((a.transform.rotation.cpu() - s_ * b.transform
                        .rotation).abs().max()) for s_ in (1.0, -1.0))
        return [("quaternion", dq, 1e-3),
                ("translation", float((a.transform.translation.cpu()
                                       - b.transform.translation).abs()
                                      .max()), 1e-3)]

    out["icp_point_to_point"] = refine_row(
        torch, card, "icp_point_to_point (4096 vs 4096, 20 iterations, gate "
        "2.0 m)", icp, icp_cmp, 20)

    def planar(dev):
        q, d = bevs(dev)
        init = torch.tensor([1.2, -0.8, yaw], device=dev)
        return lambda: refine.refine_match_icp(
            q.image, q.origin_xy, d.image, d.origin_xy, init,
            bcfg.resolution, budget=4096, iterations=10)

    out["refine_match_icp"] = refine_row(
        torch, card, "refine_match_icp (768² BEVs, budget 4096, 10 "
        "iterations)", planar, lambda a, b: [
            ("(dx, dy, yaw)", xy_yaw_diff(a.xy_yaw.cpu(), b.xy_yaw), 1e-3),
            ("inliers", float(abs(int(a.num_inliers)
                                  - int(b.num_inliers))), 0)], 20)

    def grid(dev):
        d, m = on(dev, dst3, mask)
        return lambda: refine.build_ndt_grid_3d(d, m, origin, dims, 1.0)

    def grid_cmp(a, b):
        va = a.valid.cpu()
        s_a = float(refine.ndt_score_3d(
            refine.NDTGrid3D(*(x.cpu() if torch.is_tensor(x) else x
                               for x in a)), *on("cpu", pts3, mask),
            torch.zeros(6)))
        s_b = float(refine.ndt_score_3d(b, *on("cpu", pts3, mask),
                                        torch.zeros(6)))
        return [("valid voxels differing", float((va != b.valid).sum()), 0),
                ("means", float((a.mean.cpu()[va] - b.mean[va]).abs()
                                .max()), 1e-4),
                ("score at the zero pose", abs(s_a - s_b), 1e-3)]

    out["build_ndt_grid_3d"] = refine_row(
        torch, card, "build_ndt_grid_3d (131 072-row pad, 100 000 points, "
        "100x100x12 at 1 m)", grid, grid_cmp, 20)
    cpu_grid = grid("cpu")()
    print(f"[refine-ops] NDT map: {int(cpu_grid.valid.sum())} valid voxels "
          f"of {cpu_grid.valid.numel()}")

    def ndt(dev):
        g = refine.NDTGrid3D(*(x.to(dev) if torch.is_tensor(x) else x
                               for x in cpu_grid))
        p, m = on(dev, pts3, mask)
        return lambda: refine.ndt_refine_3d(g, p, m, torch.zeros(
            6, device=dev), iterations=35)

    # the walk's last steps are 4-6 mm long (0.15 m × 0.9^i), each along a
    # normalised gradient that near the optimum follows the summation
    # order: the pose is held to 1e-2, the likelihood to 1e-3
    out["ndt_refine_3d"] = refine_row(
        torch, card, "ndt_refine_3d (35 iterations, the CPU's map on both)",
        ndt, lambda a, b: [
            ("pose", float((a[0].cpu() - b[0]).abs().max()), 1e-2),
            ("score", abs(float(a[1]) - float(b[1])), 1e-3)], 5)

    def sweep(dev):
        p, m = on(dev, pts3, mask)
        d = bevs(dev)[1]
        return lambda: refine.ergodic_rp_sweep_match(
            p, m, d.image, d.origin_xy, bcfg, mcfg)

    cell = bcfg.resolution * mcfg.fine_downsample
    out["ergodic_rp_sweep_match"] = refine_row(
        torch, card, "ergodic_rp_sweep_match (49 BEVs at 768², fm preset)",
        sweep, lambda a, b: [
            ("(roll, pitch)", float((a[1].cpu() - b[1]).abs().max()), 0),
            ("success", float(bool(a[0].success) != bool(b[0].success)), 0),
            ("(dx, dy)", float((a[0].xy_yaw[:2].cpu()
                                - b[0].xy_yaw[:2]).abs().max()),
             cell + 1e-3)], 2)

    def wall_bev(dev):
        p, m = on(dev, wall_scan[0][:, :3], wall_scan[1])
        b = scan_to_bev(p, m, bcfg)
        occ = F.max_pool2d((b.image < 0.5).float()[None, None], 5, 1, 2)
        return 1.0 - occ[0, 0], b.origin_xy

    def blobs(dev):
        image, origin_xy = wall_bev(dev)
        return lambda: contour.contour_virtual_cloud(
            image, origin_xy, bcfg.resolution, budget=4096)

    def blobs_cmp(a, b):
        return [("points", float((a[0].cpu() - b[0]).abs().max()), 0),
                ("validity", float((a[1].cpu() != b[1]).sum()), 0)]

    out["contour_virtual_cloud"] = refine_row(
        torch, card, "contour_virtual_cloud (768² BEV, budget 4096)", blobs,
        blobs_cmp, 20)
    occ = contour.erode3x3(wall_bev("cuda")[0] < 0.5)
    final = contour.connected_components(occ)
    sweeps = next(k for k in range(1, 4096) if torch.equal(
        contour.connected_components(occ, k), final))
    reads = -(-(sweeps + 1) // contour.SWEEPS_PER_READ)
    try:
        F.max_pool2d(torch.zeros((1, 1, 8, 8), dtype=torch.int32,
                                 device="cuda"), 3, 1, 1)
        int_pool = "accepts"
    except RuntimeError as e:
        int_pool = f"refuses ({str(e).splitlines()[0]})"
    print(f"[refine-ops] connected components at 768²: {sweeps} sweeps to "
          f"converge, {reads} reads of the changed flag per call; "
          f"{int((occ > 0.5).sum())} pixels after erosion; CUDA "
          f"max_pool2d on int32 {int_pool} (the port pools float32 labels)")
    out["contour_virtual_cloud"].update(sweeps=sweeps, flag_reads=reads)
    return out


def run_refine(torch, cfg, lq_set, kf_set, q_set, centroids, model,
               aligned_results, card):
    """The [refine] phases: (a) the ICP polish and match_keyframe at full
    width, (b) the SLAM example, (c) the refiners at their bench shapes.
    Returns the JSON record and the kernels' launches on its paths."""
    t0 = time.perf_counter()
    k1, locate_ms = phase_refine_polish(torch, cfg, lq_set, centroids)
    k2 = phase_refine_aligned(torch, cfg, model, kf_set, q_set,
                              aligned_results)
    phase_refine_reference(torch, cfg, lq_set, centroids)
    slam = phase_refine_slam(torch)
    ops = phase_refine_ops(torch, card, lq_set[0][1][0])
    seconds = time.perf_counter() - t0
    print(f"[refine] all phases {seconds:.1f} s")
    return {"locate_ms": locate_ms, "slam": slam, "ops": ops,
            "seconds": seconds}, k1, k2


# ---------------------------------------------------------------- [eval]
EVAL_FRAMES = 50          # one KITTI odometry sequence, ~2 m apart
EVAL_SEQ = "08"
EVAL_BATCH = 8
EVAL_N_VALUES = (1, 5, 10, 20)
EVAL_FAR = (0.0, 95.0, 0.4)   # > 140 m from every frame: no wall in common
# a KITTI-like T_cam0_velo (the calib.txt "Tr"): the axis swap (velodyne
# x forward, z up → camera z forward, y down), a small tilt, the offset
EVAL_TR = np.array([[-0.0018, -0.9999, -0.0125, -0.0047],
                    [-0.0065, 0.0125, -0.9999, -0.0716],
                    [0.9999, -0.0019, -0.0065, -0.3442],
                    [0.0, 0.0, 0.0, 1.0]])


def eval_trajectory(n: int = EVAL_FRAMES):
    """(x, y, yaw) of n frames 2 m apart along y ≈ -55 m, heading swaying
    within ±0.35 rad."""
    poses, x, y = [], -50.0, -55.0
    for i in range(n):
        yaw = 0.35 * math.sin(i / 5.0)
        poses.append((x, y, yaw))
        x, y = x + 2.0 * math.cos(yaw), y + 2.0 * math.sin(yaw)
    return poses


def velo_pose(x, y, yaw) -> np.ndarray:
    t = np.eye(4)
    t[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                 [math.sin(yaw), math.cos(yaw)]]
    t[:2, 3] = x, y
    return t


def write_kitti_sequence(world, root: str, n_pad: int):
    """The KITTI odometry layout of one sequence under ``root``:
    sequences/08/velodyne/NNNNNN.bin (float32 x, y, z, intensity of the real
    rows of each walled-world scan), poses/08.txt (cam0 poses: T_w_velo ·
    Tr⁻¹) and sequences/08/calib.txt (P0 and Tr). Returns (velodyne poses
    (N, 4, 4), the padded scans as written, the bytes written)."""
    seq = os.path.join(root, "sequences", EVAL_SEQ)
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(root, "poses"))
    velo, scans, cam, nbytes = [], [], [], 0
    for i, p in enumerate(eval_trajectory()):
        pts, mask = scan_at(world, p, n_pad, seed=500 + i)
        pts[mask > 0].tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        nbytes += pts[mask > 0].nbytes
        velo.append(velo_pose(*p))
        cam.append((velo[-1] @ np.linalg.inv(EVAL_TR))[:3].reshape(-1))
        scans.append((pts, mask))
    np.savetxt(os.path.join(root, "poses", f"{EVAL_SEQ}.txt"), np.stack(cam))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(["0.0"] * 12) + "\n")
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in
                                  EVAL_TR[:3].reshape(-1)) + "\n")
    return np.stack(velo), scans, nbytes


def eval_dataset(world, root: str, n_pad: int):
    """Write the sequence, split it (40 db, 10 queries), read it back
    through the port's native loader, and add a query scanned 140 m from
    every frame (no wall in common with any db scan: registration must
    fail)."""
    from gloc3d_tpu_torch.data import kitti

    t0 = time.perf_counter()
    velo, written, nbytes = write_kitti_sequence(world, root, n_pad)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = kitti.generate_split(root, sequences=(EVAL_SEQ,), skip_frames=1,
                                 query_fraction=0.2, seed=0)
    ds = kitti.load_split_scans(split, max_points=n_pad)
    t_read = time.perf_counter() - t0
    check((ds.num_db, ds.num_q) == (40, 10),
          f"[eval] split {ds.num_db} db / {ds.num_q} queries, not 40 / 10")
    frame = {f: int(os.path.basename(f)[:6]) for f in
             split.db_files + split.q_files}
    worst, same = 0.0, True
    for files, inputs, masks, poses in (
            (split.db_files, ds.db_inputs, ds.db_masks, ds.db_poses),
            (split.q_files, ds.q_inputs, ds.q_masks, ds.q_poses)):
        for f, x, m, pose in zip(files, inputs, masks, poses):
            pts, mask = written[frame[f]]
            same &= np.array_equal(x, pts) and np.array_equal(m, mask)
            worst = max(worst, float(np.abs(pose - velo[frame[f]]).max()))
    print(f"[eval] wrote {EVAL_FRAMES} scans ({n_pad}-point pad, "
          f"{nbytes / 1e6:.1f} MB) in {t_write:.2f} s; split and read back "
          f"(native loader) in {t_read:.2f} s: {ds.num_db} db, "
          f"{ds.num_q} queries; scans "
          f"bit-equal {same}; velodyne poses through Tr within {worst:.2e} "
          f"(bound 1e-5)")
    check(same, "[eval] the loaded scans differ from the written ones")
    check(worst < 1e-5, f"[eval] velodyne poses off by {worst:.2e}")

    far, far_mask = scan_at(world, EVAL_FAR, n_pad, seed=600)
    far_pose = velo_pose(*EVAL_FAR)
    ds.q_inputs = np.concatenate([ds.q_inputs, far[None]])
    ds.q_masks = np.concatenate([ds.q_masks, far_mask[None]])
    ds.q_poses = np.concatenate([ds.q_poses, far_pose[None]])
    ds.utm_q = np.concatenate([ds.utm_q, far_pose[None, :2, 3]])
    return ds


class BatchRecorder:
    """Keeps the results of every ``locate_batch`` call of a localizer, so
    the evaluator's per-query results can be compared with ``locate``."""

    def __init__(self, loc):
        self.calls, self._real = [], loc.locate_batch
        loc.locate_batch = self

    def __call__(self, *args):
        out = self._real(*args)
        self.calls.append(out)
        return out

    def results(self, nq: int, batch: int):
        """The first nq results, the padding of each batch dropped."""
        return [r for i, rs in enumerate(self.calls)
                for r in rs[: max(0, min(batch, nq - i * batch))]]


def eval_subset(ds, n_db: int, n_q: int):
    from gloc3d_tpu_torch.data.dataset import TripletDataset

    return TripletDataset(
        db_inputs=ds.db_inputs[:n_db], q_inputs=ds.q_inputs[:n_q],
        utm_db=ds.utm_db[:n_db], utm_q=ds.utm_q[:n_q],
        db_masks=ds.db_masks[:n_db], q_masks=ds.q_masks[:n_q],
        db_poses=ds.db_poses[:n_db], q_poses=ds.q_poses[:n_q])


def check_eval_report(tag, report, nq: int, far: int, out_dir: str,
                      overlays, card: str):
    """Gates (b) and (c); the report and its latencies printed.
    ``overlays`` holds the paths the evaluator handed to save_png."""
    reg = report.registration
    print(f"[eval] {tag} report: " + json.dumps(json.loads(
        report.to_json())))
    lat = report.latency_ms
    print(f"[eval] {tag}: db build {lat['db_build_per_scan']:.3f} ms per "
          f"scan, locate {lat['locate_per_query']:.3f} ms per query (p50 "
          f"{lat['locate_per_query_p50']:.3f}, p95 "
          f"{lat['locate_per_query_p95']:.3f} over the batches after the "
          f"first), host clock, batch {EVAL_BATCH}; {card}")
    check(reg["num_total"] == nq, f"[eval] {tag}: num_total "
          f"{reg['num_total']} != {nq}")
    check(reg["success_rate"] >= 2 / 3 and reg["mean_pos_err_m"] < 1.0
          and report.recognition_recall[5] >= 2 / 3,
          f"[eval] {tag}: success {reg['success_rate']:.3f}, mean error "
          f"{reg['mean_pos_err_m']:.3f} m, recall@5 "
          f"{report.recognition_recall[5]:.3f} (gates 2/3, 1 m, 2/3)")
    check(far in report.failed_registration_indices,
          f"[eval] {tag}: the far query {far} registered")
    # npz dumps go to failed detections only (a GT positive, none in the
    # top-k); the far query has no positive, so its dump is the overlay
    fc = os.path.join(out_dir, "failure_cases")
    npz = sorted(f for f in os.listdir(fc) if f.endswith(".npz"))
    want = sorted(f"query_{i}.npz" for i in report.failed_detect_indices[:50])
    check(npz == want, f"[eval] {tag}: npz dumps {npz}, expected {want}")
    for name in npz:
        with np.load(os.path.join(fc, name)) as d:
            check(d["query"].dtype == np.uint8 and d["query"].shape
                  == d["gt_positive"].shape == d["top_prediction"].shape,
                  f"[eval] {tag}: {name}'s arrays")
    rendered = [os.path.basename(p) for p in overlays]
    check(any(r.startswith(f"reg_fail_overlay_{far}_vs_") for r in rendered),
          f"[eval] {tag}: no overlay rendered for the far query: {rendered}")
    for name, listed in (("failed_detect_indices.txt",
                          report.failed_detect_indices),
                         ("failed_registration_indices.txt",
                          report.failed_registration_indices)):
        with open(os.path.join(out_dir, name)) as f:
            got = [int(v) for v in f.read().split()]
        check(got == listed, f"[eval] {tag}: {name} lists {got}")
    try:
        import matplotlib  # noqa: F401
        backend = True
    except ImportError:
        backend = False
    pngs = sorted(f for f in os.listdir(fc) if f.endswith(".png"))
    check(pngs == (sorted(rendered) if backend else []),
          f"[eval] {tag}: overlay PNGs {pngs}, rendered {rendered}, "
          f"matplotlib {'present' if backend else 'absent'}")
    print(f"[eval] {tag}: far query {far} in failed_registration_indices; "
          f"overlays rendered {rendered}, PNGs written {len(pngs)} "
          f"(matplotlib {'present' if backend else 'absent'}); npz dumps "
          f"{npz} (= the failed detections); failed-index files written")


def check_eval_launches(torch, tag, loc, ds):
    """Every K1 / K2 / k-NN normals launch of one evaluator batch
    (locate_batch of the first EVAL_BATCH queries) against its plain
    version."""
    calls = record_launches(lambda: loc.locate_batch(
        ds.q_inputs[:EVAL_BATCH], ds.q_masks[:EVAL_BATCH]))
    parts = []
    for key, launches in calls.items():
        for args in launches:
            rel = check_recorded(
                torch, f"[eval] {tag} {key} {tuple(args[0].shape)}", key,
                args)
            parts.append(f"{key} {tuple(args[0].shape)} {rel:.2e}")
    check(parts, f"[eval] {tag}: no kernel launch recorded")
    print(f"[eval] {tag}: every kernel launch of one evaluator batch "
          f"against its plain version, K1 / K2 error relative to L1 mass "
          f"(bound 1e-5), KNN max |diff| (within each row's bound): "
          + ", ".join(parts))


def run_eval(loc, ds, out_dir=None, batch: int = EVAL_BATCH):
    """evaluate_split on ``loc`` → (report, per-query results, seconds)."""
    from gloc3d_tpu_torch.eval.evaluator import evaluate_split

    rec = BatchRecorder(loc)
    t0 = time.perf_counter()
    report = evaluate_split(loc, ds, out_dir=out_dir, batch=batch,
                            n_values=EVAL_N_VALUES)
    return report, rec.results(ds.num_q, batch), time.perf_counter() - t0


def phase_eval(torch, cfg, world, card, dev: str = "cuda"):
    """[eval]: evaluate_split over a KITTI-layout sequence read from disk,
    on the host-stats (K1) and the aligned all-device (K2) path, with gates
    (a)-(d). Returns the JSON record and both kernels' launches."""
    from gloc3d_tpu_torch.eval import evaluator
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    t_phase = time.perf_counter()
    n_pad = cfg.voxel.max_points
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = eval_dataset(world, os.path.join(tmp, "kitti"), n_pad)
        nq = ds.num_q
        far = nq - 1
        centroids = vlad_centroids(torch, cfg, list(zip(
            ds.db_inputs[:4], ds.db_masks[:4])), device=dev)
        model = build_serving_model(torch, cfg, "bfloat16", centroids)
        rendered = []
        real_save = evaluator.save_png

        def save_png(path, rgb):
            rendered.append(path)
            return real_save(path, rgb)

        evaluator.save_png = save_png
        paths = {"host-stats": dict(host_stats=True),
                 "aligned all-device": dict(host_stats=False,
                                            align_ground=True)}
        launches = {}
        try:
            for tag, kw in paths.items():
                counter = ss.segment_sum_sorted if kw["host_stats"] else \
                    bs.pillar_bin_sums
                loc = GlobalLocalizer(cfg, model, device=torch.device(dev),
                                      **kw)
                rendered.clear()
                reset_launches(counter)
                run_dir = os.path.join(tmp, tag.replace(" ", "_"))
                report, _, _ = run_eval(loc, ds, run_dir)
                launches[tag] = launches_of(counter)
                need = (ds.num_db // EVAL_BATCH + -(-nq // EVAL_BATCH)) * (
                    1 if kw["host_stats"] else 2)
                print(f"[eval] {tag}: "
                      f"{'K1' if kw['host_stats'] else 'K2'} launches "
                      f"{launches[tag]} (at least {need})")
                check(launches[tag] >= need,
                      f"[eval] {tag}: {launches[tag]} launches")
                check_eval_report(tag, report, nq, far, run_dir, rendered,
                                  card)
                check_eval_launches(torch, tag, loc, ds)
                out[tag] = json.loads(report.to_json())
        finally:
            evaluator.save_png = real_save

        # (a) the evaluator adds bookkeeping, not results: on the fp32
        # host-stats map its per-query results equal locate's, query by
        # query (in bf16 the batch of 8 and the batch of 1 may round the
        # descriptors apart and reorder near-tied candidates)
        model32 = build_serving_model(torch, cfg, "float32", centroids)
        loc = GlobalLocalizer(cfg, model32, device=torch.device(dev),
                              host_stats=True)
        _, batched, _ = run_eval(loc, ds)
        single = [loc.locate(ds.q_inputs[i], ds.q_masks[i])
                  for i in range(nq)]
        worst = same_results("[eval] evaluator vs locate", batched,
                                single)
        print(f"[eval] (a) fp32 host stats: the evaluator's {nq} results = "
              f"locate's query by query (success, keyframe, ranked "
              f"candidates; (dx, dy, yaw) within {worst:.2e}, bound 1e-4)")

        # (d) the CPU's run on the first 16 db and 4 query scans
        sub = eval_subset(ds, 16, 4)
        runs = {}
        for d in (dev, "cpu"):
            m = build_serving_model(torch, cfg, "float32", centroids)
            runs[d] = run_eval(GlobalLocalizer(
                cfg, m, device=torch.device(d), host_stats=True), sub,
                batch=4)
        (r_dev, q_dev, _), (r_cpu, q_cpu, t_cpu) = runs[dev], runs["cpu"]
        worst = same_results("[eval] card vs CPU", q_dev, q_cpu,
                                xy_tol=1e-3)
        check(r_dev.failed_detect_indices == r_cpu.failed_detect_indices
              and r_dev.failed_registration_indices
              == r_cpu.failed_registration_indices
              and r_dev.recognition_recall == r_cpu.recognition_recall
              and r_dev.registration["num_success"]
              == r_cpu.registration["num_success"],
              "[eval] card report != CPU report")
        derr = max(abs(r_dev.registration[k] - r_cpu.registration[k])
                   for k in ("mean_pos_err_m", "std_pos_err_m"))
        rerr = max(abs(r_dev.registration[k] - r_cpu.registration[k])
                   for k in ("mean_rot_err_deg", "std_rot_err_deg"))
        print(f"[eval] (d) card vs CPU, fp32, 16 db + 4 queries: same "
              f"candidates, successes and failed indices; (dx, dy, yaw) "
              f"within {worst:.2e}, mean/std errors within {derr:.2e} m / "
              f"{math.radians(rerr):.2e} rad (bounds 1e-3); CPU run "
              f"{t_cpu:.1f} s")
        check(derr <= 1e-3 and math.radians(rerr) <= 1e-3,
              "[eval] card errors differ from the CPU's")
    seconds = time.perf_counter() - t_phase
    print(f"[eval] phase wall time {seconds:.1f} s")
    out["seconds"] = seconds
    return out, launches["host-stats"], launches["aligned all-device"]


# ---------------------------------------------------------------- [cli]
CLI_BATCH = 8
CLI_MISSING = "/nonexistent/scan.bin"
CLI_ROTATIONS = 512       # match-submap: one angular step 2π/512

# python -m gloc3d_tpu_torch.cli, with the moments it reaches printed to
# stderr as JSON: imports done, localizer built (model, checkpoint, CUDA
# context), index loaded, first query answered
CLI_COLD_START = textwrap.dedent("""
    import time
    t_main = time.time()
    import json, runpy, sys
    import torch
    from gloc3d_tpu_torch import pipeline
    t_import = time.time()
    marks = {}

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            marks[name] = (t0, time.time())
            return out
        return run

    G = pipeline.GlobalLocalizer
    G.__init__ = timed("build", G.__init__)
    G.load = timed("load", G.load)
    G.locate = timed("locate", G.locate)
    sys.argv = ["gloc"] + sys.argv[1:]
    code = 0
    try:
        runpy.run_module("gloc3d_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        code = e.code
    print(json.dumps({"t_main": t_main, "t_import": t_import,
                      "marks": marks}), file=sys.stderr)
    sys.exit(code)
""")

# a fresh process that reloads exported blobs onto the card with the ops
# module alone and runs them on one scan
CLI_RELOAD = textwrap.dedent("""
    import io, sys
    import numpy as np
    import torch
    import gloc3d_tpu_torch.kernels.ops  # registers the gloc3d:: ops
    from gloc3d_tpu_torch.kernels import bin_sums
    from torch.export.passes import move_to_device_pass

    # the live model it is held to runs with TF32 off (phase_device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = np.load(sys.argv[1])
    out = {}
    for i, path in enumerate(sys.argv[2:-1]):
        with open(path, "rb") as f:
            prog = move_to_device_pass(torch.export.load(
                io.BytesIO(f.read())), "cuda")
        before = bin_sums.pillar_bin_sums.launches
        with torch.no_grad():
            d = prog.module()(torch.from_numpy(inputs["pts"]).cuda(),
                              torch.from_numpy(inputs["mask"]).cuda())
        out[f"desc{i}"] = d.cpu().numpy()
        out[f"k2_{i}"] = bin_sums.pillar_bin_sums.launches - before
    heavy = [m for m in sys.modules if m.startswith((
        "gloc3d_tpu_torch.models", "gloc3d_tpu_torch.pipeline",
        "gloc3d_tpu_torch.config", "jax", "flax"))
        or m == "gloc3d_tpu" or m.startswith("gloc3d_tpu.")]
    assert not heavy, heavy
    np.savez(sys.argv[-1], **out)
""")


class _Stamped(io.StringIO):
    """Captured stdout that stamps the time each line ends."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def write(self, s):
        n = super().write(s)
        if s.endswith("\n"):
            self.stamps.append(time.perf_counter())
        return n


class _Lines:
    """stdin of scan paths that stamps the time each line is read."""

    def __init__(self, lines):
        self.lines, self.stamps = lines, []

    def __iter__(self):
        for line in self.lines:
            self.stamps.append(time.perf_counter())
            yield line + "\n"


def cli_call(argv, stdin=None, stdout=None):
    """``cli.main(argv)`` in this process, stdout captured → (lines,
    seconds); a non-zero exit fails the smoke."""
    from gloc3d_tpu_torch import cli

    out = stdout if stdout is not None else io.StringIO()
    real_stdin = sys.stdin
    if stdin is not None:
        sys.stdin = stdin
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main([str(a) for a in argv])
    finally:
        sys.stdin = real_stdin
    seconds = time.perf_counter() - t0
    check(rc == 0, f"[cli] {argv[0]} exited {rc}: {out.getvalue()[-2000:]}")
    return out.getvalue().strip().splitlines(), seconds


def same_json(tag, got, want, xy_tol=1e-4):
    """Two result JSONs: success and keyframe equal, the same candidates in
    the same order, translation within xy_tol m."""
    check(got["success"] == want["success"]
          and got["db_index"] == want["db_index"]
          and got["candidates"] == want["candidates"],
          f"{tag}: {got} != {want}")
    if "translation" in want:
        d = float(np.abs(np.subtract(got["translation"],
                                     want["translation"])).max())
        check(d <= xy_tol, f"{tag}: translations {d:.3e} m apart")
        return d
    check("translation" not in got, f"{tag}: only one side registered")
    return 0.0


def relative_xy_yaw(a, b):
    """Pose of frame a in frame b, (x, y, yaw), from (x, y, yaw) poses."""
    t = np.linalg.inv(velo_pose(*b)) @ velo_pose(*a)
    return t[0, 3], t[1, 3], math.atan2(t[1, 0], t[0, 0])


def cli_dataset(world, root: str, n_pad: int):
    """[eval]'s KITTI sequence 08 under ``root``, and an empty sequence 09
    (no frames), so that ``gen-split --which val`` (sequences 08 and 09)
    reads sequence 08 alone."""
    write_kitti_sequence(world, root, n_pad)
    seq = os.path.join(root, "sequences", "09")
    os.makedirs(os.path.join(seq, "velodyne"))
    open(os.path.join(root, "poses", "09.txt"), "w").close()
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in
                                  EVAL_TR[:3].reshape(-1)) + "\n")


def phase_cli(torch, cfg, world, card):
    """[cli]: every subcommand of gloc3d_tpu_torch/cli.py at full width on
    a KITTI layout read from disk (steps 1-12 of the module docstring).
    Returns (the JSON record, K1 launches, K2 launches, exported-program
    K2 launches)."""
    from gloc3d_tpu_torch import cli
    from gloc3d_tpu_torch.data import kitti, native
    from gloc3d_tpu_torch.export import (
        ExportedDescriptorModel, load_exported, load_program)
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer
    from gloc3d_tpu_torch.profiling import TRACE_FILE, trace

    t_phase = time.perf_counter()
    n_pad = cfg.voxel.max_points
    dev = torch.device("cuda")
    rec, times = {}, {}
    k1 = k2 = k2_export = 0
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        cli_dataset(world, root, n_pad)
        p = {k: os.path.join(tmp, k) for k in (
            "split.npz", "cfg.json", "cfg32.json", "cfg_train.json",
            "ckpt.pt", "idx_hs", "idx_al", "idx_dp1", "idx_dp2",
            "blob_card.pt2", "blob_cpu.pt2",
            "imgs", "cents.npz", "train", "eval", "trace", "inputs.npz",
            "reloaded.npz")}
        cfg32 = cfg.replace(model=cfg.model.replace(compute_dtype="float32"))
        cfg_train = cfg.replace(
            model=cfg.model.replace(fold_bn=False),
            train=cfg.train.replace(epochs=1))
        for key, c in (("cfg.json", cfg), ("cfg32.json", cfg32),
                       ("cfg_train.json", cfg_train)):
            with open(p[key], "w") as f:
                f.write(c.to_json())

        # 1. gen-split = [eval]'s split
        cli_call(["gen-split", "--root", root, "--which", "val",
                  "--skip-frames", "1", "--query-fraction", "0.2",
                  "--out", p["split.npz"]])
        split = kitti.SplitIndex.load(p["split.npz"])
        want = kitti.generate_split(root, sequences=(EVAL_SEQ,),
                                    skip_frames=1, query_fraction=0.2,
                                    seed=0)
        check(split.db_files == want.db_files
              and split.q_files == want.q_files
              and np.array_equal(split.db_poses, want.db_poses)
              and np.array_equal(split.q_poses, want.q_poses),
              "[cli] gen-split differs from [eval]'s split")
        print(f"[cli] 1. gen-split: {len(split.db_files)} db, "
              f"{len(split.q_files)} queries = [eval]'s split")

        # the smoke's seeded weights and NetVLAD centroids as a port
        # checkpoint (the standard model; the CLI folds it into the
        # fold_bn=True serving model)
        first = native.load_scan_batch(split.db_files[:4], "kitti", n_pad)
        masks = native.masks_from_counts(first[1], n_pad)
        centroids = vlad_centroids(torch, cfg, list(zip(first[0], masks)))
        std = seeded_standard_model(torch, cfg, "float32")
        with torch.no_grad():
            std.pool.centroids.copy_(centroids)
            std.pool.conv.weight.copy_(30.0 * centroids[:, :, None, None])
        torch.save({"model": std.state_dict()}, p["ckpt.pt"])
        served = build_serving_model(torch, cfg, "bfloat16", centroids)
        common = ["--config", p["cfg.json"], "--checkpoint", p["ckpt.pt"]]
        hs_flags = ["--host-stats", "--device-keyframes"]
        al_flags = ["--align-ground", "--device-keyframes",
                    "--no-host-mirror"]

        # 2. build-index, host stats (K1) and aligned all-device (K2)
        for key, flags, counter in (
                ("idx_hs", hs_flags, ss.segment_sum_sorted),
                ("idx_al", al_flags, bs.pillar_bin_sums)):
            reset_launches(counter)
            _, times[f"build-index {key}"] = cli_call(
                ["build-index", "--split", p["split.npz"], "--out", p[key],
                 "--batch", CLI_BATCH, *common, *flags])
            n = launches_of(counter)
            need = -(-len(split.db_files) // CLI_BATCH) * (
                1 if key == "idx_hs" else 2)
            print(f"[cli] 2. build-index {' '.join(flags)}: "
                  f"{len(split.db_files)} keyframes in "
                  f"{times[f'build-index {key}']:.2f} s, "
                  f"{'K1' if key == 'idx_hs' else 'K2'} launches {n} (at "
                  f"least {need})")
            check(n >= need, f"[cli] build-index {key}: {n} launches")
            if key == "idx_hs":
                k1 += n
            else:
                k2 += n

        # 2b. build-index --dp-devices 2: two gloo ranks spawned on the one
        # card (fp32, host stats) = the same build at --dp-devices 1
        dp_common = ["build-index", "--split", p["split.npz"], "--batch",
                     CLI_BATCH, "--config", p["cfg32.json"], "--checkpoint",
                     p["ckpt.pt"], "--host-stats"]
        for key, n_dp in (("idx_dp1", 1), ("idx_dp2", 2)):
            _, times[f"build-index {key}"] = cli_call(
                dp_common + ["--out", p[key], "--dp-devices", n_dp])
        one, two = ({f: dict(np.load(os.path.join(p[key], f))) for f in (
            "bank.npz", "keyframes.npz")} for key in ("idx_dp1", "idx_dp2"))
        n_kf = len(split.db_files)
        err = float(np.abs(two["bank.npz"]["bank"][:n_kf]
                           - one["bank.npz"]["bank"][:n_kf]).max())
        same = all(np.array_equal(two["keyframes.npz"][k],
                                  one["keyframes.npz"][k])
                   for k in ("images", "origins"))
        check(len(two["keyframes.npz"]["images"]) == n_kf and same
              and err <= 1e-5, f"[cli] build-index --dp-devices 2: "
              f"{len(two['keyframes.npz']['images'])} keyframes, images "
              f"equal {same}, descriptors {err:.1e} from --dp-devices 1's")
        print(f"[cli] 2b. build-index --dp-devices 2 (two gloo ranks on the "
              f"card, fp32, host stats): {n_kf} keyframes in "
              f"{times['build-index idx_dp2']:.2f} s (spawn included) "
              f"against {times['build-index idx_dp1']:.2f} s at "
              f"--dp-devices 1; keyframe images and origins equal, "
              f"descriptors within {err:.1e}")
        rec["build_index_dp2"] = {"seconds": times["build-index idx_dp2"],
                                  "dp1_seconds": times["build-index idx_dp1"],
                                  "max_desc_err": err}

        # 3. query on each index = locate in this process on the loaded map
        q0 = split.q_files[0]
        pts, counts = native.load_scan_batch([q0], "kitti", n_pad)
        mask = native.masks_from_counts(counts, n_pad)
        live = {}
        for key, flags, kw, counter in (
                ("idx_hs", hs_flags, dict(host_stats=True,
                                          device_keyframes=True),
                 ss.segment_sum_sorted),
                ("idx_al", al_flags, dict(align_ground=True,
                                          device_keyframes=True,
                                          host_mirror=False),
                 bs.pillar_bin_sums)):
            reset_launches(counter)
            lines, times[f"query {key}"] = cli_call(
                ["query", "--index", p[key], "--scan", q0, *common, *flags])
            n = launches_of(counter)
            got = json.loads(lines[-1])
            loc = GlobalLocalizer(cfg, served, device=dev, **kw)
            loc.load(p[key])
            live[key] = cli._result_json(loc.locate(pts[0], mask[0]))
            d = same_json(f"[cli] 3. query {key}", got, live[key])
            check(n >= 1, f"[cli] query {key}: no kernel launch")
            if key == "idx_hs":
                k1 += n
            else:
                k2 += n
            print(f"[cli] 3. query {' '.join(flags)}: {json.dumps(got)} = "
                  f"locate on the loaded map (keyframe, candidates "
                  f"ranked; translation within {d:.2e} m, "
                  f"bound 1e-4); {times[f'query {key}']:.2f} s in-process "
                  f"(localizer, map load, query)")

        # 4. one query as a real subprocess: the cold start, split
        env = dict(os.environ, PYTHONPATH=REPO)
        t_launch = time.time()
        r = subprocess.run(
            [sys.executable, "-c", CLI_COLD_START, "query", "--index",
             p["idx_hs"], "--scan", q0, *common, *hs_flags],
            env=env, capture_output=True, text=True, timeout=300)
        t_end = time.time()
        check(r.returncode == 0, f"[cli] subprocess query failed: "
              f"{r.stderr[-3000:]}")
        marks = json.loads(r.stderr.strip().splitlines()[-1])
        m = marks["marks"]
        cold = {"start_to_import_s": marks["t_import"] - t_launch,
                "interpreter_s": marks["t_main"] - t_launch,
                "localizer_built_s": m["build"][1] - marks["t_import"],
                "index_load_s": m["load"][1] - m["load"][0],
                "first_query_s": m["locate"][1] - m["locate"][0],
                "exit_s": t_end - m["locate"][1],
                "total_s": t_end - t_launch}
        same_json("[cli] 4. subprocess query", json.loads(
            r.stdout.strip().splitlines()[-1]), live["idx_hs"])
        print(f"[cli] 4. cold start of `python -m gloc3d_tpu_torch.cli "
              f"query --host-stats` (kernels already built): process start "
              f"to imports done {cold['start_to_import_s']:.2f} s (of it "
              f"the interpreter {cold['interpreter_s']:.2f} s), localizer "
              f"built (model, checkpoint, CUDA context) "
              f"{cold['localizer_built_s']:.2f} s, index load "
              f"{cold['index_load_s']:.2f} s, first query "
              f"{cold['first_query_s']:.2f} s, exit {cold['exit_s']:.2f} s; "
              f"total {cold['total_s']:.2f} s; the answer = step 3's; "
              f"{card}")
        rec["cold_start"] = cold

        # 5. serve: the 10 query paths and a missing file on the
        # host-stats map with the device store (fused)
        stream = split.q_files[:5] + [CLI_MISSING] + split.q_files[5:]
        stdin, stdout = _Lines(stream), _Stamped()
        reset_launches(ss.segment_sum_sorted)
        lines, times["serve"] = cli_call(
            ["serve", "--index", p["idx_hs"], *common, *hs_flags],
            stdin=stdin, stdout=stdout)
        k1 += launches_of(ss.segment_sum_sorted)
        out = [json.loads(ln) for ln in lines]
        check(out[0]["ready"] and out[0]["fused"] is True
              and out[0]["db_size"] == len(split.db_files),
              f"[cli] 5. serve header {out[0]}")
        check(len(out) == len(stream) + 1, f"[cli] 5. serve gave "
              f"{len(out) - 1} lines for {len(stream)}")
        loc = GlobalLocalizer(cfg, served, device=dev, host_stats=True,
                              device_keyframes=True)
        loc.load(p["idx_hs"])
        worst = 0.0
        for path, got in zip(stream, out[1:]):
            check(got["scan"] == path, f"[cli] 5. line for {got['scan']}")
            if path == CLI_MISSING:
                check(got["success"] is False and "error" in got,
                      f"[cli] 5. missing file: {got}")
                continue
            x, c = native.load_scan_batch([path], "kitti", n_pad)
            want = cli._result_json(loc.locate(
                x[0], native.masks_from_counts(c, n_pad)[0]))
            worst = max(worst, same_json(f"[cli] 5. serve {path}", got,
                                         want))
        per_line = [(stdout.stamps[i + 1] - stdin.stamps[i]) * 1e3
                    for i in range(len(stream))]
        warm = [t for path, t in zip(stream[1:], per_line[1:])
                if path != CLI_MISSING]
        rec["serve_ms_per_line"] = {"first": per_line[0],
                                    "warm_median": float(np.median(warm)),
                                    "warm_max": max(warm)}
        err_line = out[stream.index(CLI_MISSING) + 1]["error"][:60]
        print(f"[cli] 5. serve (fused {out[0]['fused']}, captured CUDA "
              f"graphs: the first line includes the capture): "
              f"{len(stream) - 1} lines = each scan's locate on the loaded "
              f"map (translations within {worst:.2e} m), the missing file "
              f"an error line ({err_line}...) and the stream went on; ms "
              f"per line (read to "
              f"answer written, host clock): first {per_line[0]:.1f}, warm "
              f"median {np.median(warm):.1f}, max {max(warm):.1f}; {card}")

        # 6. export on the card and on the CPU (fp32), the CPU blob moved
        # to the card by load_exported
        np.savez(p["inputs.npz"], pts=pts, mask=mask)
        for key, flags in (("blob_card.pt2", []),
                           ("blob_cpu.pt2", ["--device", "cpu"])):
            _, times[f"export {key}"] = cli_call(
                ["export", "--out", p[key], "--config", p["cfg32.json"],
                 "--checkpoint", p["ckpt.pt"], "--fold-bn", *flags])
        live32 = build_serving_model(torch, cfg32, "float32", centroids
                                     ).to(dev)
        with torch.no_grad():
            want = live32(torch.from_numpy(pts).to(dev),
                          torch.from_numpy(mask).to(dev)).cpu().numpy()
        for key in ("blob_card.pt2", "blob_cpu.pt2"):
            with open(p[key], "rb") as f:
                blob = f.read()
            targets = [str(n.target) for n in load_program(blob).graph.nodes
                       if n.op == "call_function"]
            plain = [t for t in targets if "index_add" in t
                     or "bincount" in t]
            n_op = targets.count("gloc3d.pillar_bin_sums.default")
            check(n_op == 2 and not plain, f"[cli] 6. {key}: "
                  f"{n_op} gloc3d::pillar_bin_sums nodes, plain {plain}")
            fn = load_exported(blob)
            reset_launches(bs.pillar_bin_sums)
            got = fn(pts, mask).cpu().numpy()
            n = launches_of(bs.pillar_bin_sums)
            k2_export += n
            err = float(np.abs(got - want).max())
            check(n == 2 and err <= 1e-5, f"[cli] 6. {key} on the card: "
                  f"{n} K2 launches, descriptors {err:.3e} from the live "
                  f"model's")
            print(f"[cli] 6. export {key} ({len(blob)} bytes, "
                  f"{times[f'export {key}']:.2f} s): the graph holds "
                  f"gloc3d::pillar_bin_sums x{n_op} and no index_add_ / "
                  f"bincount; on the card K2 launched {n} times, "
                  f"descriptors {err:.2e} from the live fp32 model's "
                  f"(bound 1e-5)")
        r = subprocess.run(
            [sys.executable, "-c", CLI_RELOAD, p["inputs.npz"],
             p["blob_card.pt2"], p["blob_cpu.pt2"], p["reloaded.npz"]],
            env=env, capture_output=True, text=True, timeout=300)
        check(r.returncode == 0, f"[cli] 6. fresh reload failed: "
              f"{r.stderr[-3000:]}")
        with np.load(p["reloaded.npz"]) as d:
            errs = [float(np.abs(d[f"desc{i}"] - want).max())
                    for i in range(2)]
            fresh_k2 = [int(d[f"k2_{i}"]) for i in range(2)]
        k2_export += sum(fresh_k2)
        check(max(errs) <= 1e-5 and fresh_k2 == [2, 2],
              f"[cli] 6. fresh process: errors {errs}, K2 {fresh_k2}")
        print(f"[cli] 6. a fresh process with gloc3d_tpu_torch.kernels.ops "
              f"alone (no models, pipeline or config imported) reloaded "
              f"both blobs onto the card: K2 launches {fresh_k2}, "
              f"descriptors within {max(errs):.2e} of the live model's "
              f"(bound 1e-5)")

        # 7. query --from-export = the live query (fp32, aligned map)
        res = {}
        for key, flags in (("live", ["--checkpoint", p["ckpt.pt"]]),
                           ("export", ["--from-export",
                                       p["blob_cpu.pt2"]])):
            reset_launches(bs.pillar_bin_sums)
            lines, times[f"query {key}"] = cli_call(
                ["query", "--index", p["idx_al"], "--scan", q0,
                 "--config", p["cfg32.json"], *flags, *al_flags])
            if key == "export":
                k2_export += launches_of(bs.pillar_bin_sums)
            else:
                k2 += launches_of(bs.pillar_bin_sums)
            res[key] = json.loads(lines[-1])
        d = same_json("[cli] 7. query --from-export", res["export"],
                      res["live"])
        print(f"[cli] 7. query --from-export (CPU blob on the card) = the "
              f"live fp32 query on the aligned map (keyframe, candidates "
              f"ranked, translation within {d:.2e} m); in-process "
              f"{times['query export']:.2f} s vs "
              f"{times['query live']:.2f} s live")
        # the exported against the live descriptor forward, warm
        with open(p["blob_cpu.pt2"], "rb") as f:
            fn = load_exported(f.read())
        x_d = torch.from_numpy(pts).to(dev)
        m_d = torch.from_numpy(mask).to(dev)
        with torch.no_grad():
            rec["forward_ms"] = {
                "exported": cuda_ms(torch, lambda: fn(x_d, m_d), 20),
                "live": cuda_ms(torch, lambda: live32(x_d, m_d), 20)}
        with open(p["blob_cpu.pt2"], "rb") as f:
            exported = ExportedDescriptorModel(f.read(), dev)
        loc_x = GlobalLocalizer(cfg32, exported, device=dev,
                                align_ground=True, device_keyframes=True,
                                host_mirror=False)
        loc_l = GlobalLocalizer(cfg32, live32, device=dev, align_ground=True,
                                device_keyframes=True, host_mirror=False)
        for loc in (loc_x, loc_l):
            loc.load(p["idx_al"])
        rec["locate_ms"] = {
            "exported": host_ms(torch, lambda: loc_x.locate(pts[0], mask[0]),
                                10),
            "live": host_ms(torch, lambda: loc_l.locate(pts[0], mask[0]),
                            10)}
        print(f"[cli] 7. descriptor forward, CUDA events, warm: exported "
              f"{rec['forward_ms']['exported']:.3f} ms, live "
              f"{rec['forward_ms']['live']:.3f} ms; aligned locate, host "
              f"clock: exported {rec['locate_ms']['exported']:.2f} ms, "
              f"live {rec['locate_ms']['live']:.2f} ms (fp32, 40 "
              f"keyframes); {card}")

        # 8. preprocess + stats = batch_scan_to_bev
        scans_dir = os.path.join(root, "sequences", EVAL_SEQ, "velodyne")
        _, times["preprocess"] = cli_call(
            ["preprocess", "--scans", scans_dir, "--out", p["imgs"],
             "--config", p["cfg.json"], "--batch", CLI_BATCH])
        files = sorted(os.path.join(scans_dir, f)
                       for f in os.listdir(scans_dir))
        x, c = native.load_scan_batch(files, "kitti", cfg.bev.max_points)
        m = native.masks_from_counts(c, cfg.bev.max_points)
        s = n_px = ss_ = 0.0
        for i in range(0, len(files), CLI_BATCH):
            with torch.no_grad():
                bev = batch_scan_to_bev(
                    torch.from_numpy(x[i:i + CLI_BATCH, :, :3].copy()).to(dev),
                    torch.from_numpy(m[i:i + CLI_BATCH]).to(dev), cfg.bev)
            imgs = (bev.image * 255.0).cpu().numpy().astype(np.uint8)
            for j, f in enumerate(files[i:i + CLI_BATCH]):
                stem = os.path.splitext(os.path.basename(f))[0]
                with np.load(os.path.join(p["imgs"], stem + ".npz")) as d:
                    check(np.array_equal(d["image"], imgs[j])
                          and np.array_equal(d["origin_xy"],
                                             bev.origin_xy[j].cpu().numpy()),
                          f"[cli] 8. preprocess {stem} != batch_scan_to_bev")
                img = imgs[j].astype(np.float64) / 255.0
                s, ss_, n_px = s + img.sum(), ss_ + (img * img).sum(), \
                    n_px + img.size
        stats = json.loads(cli_call(["stats", "--images", p["imgs"]])[0][-1])
        mean = s / n_px
        check(stats["files"] == len(files)
              and stats["mean"] == mean
              and abs(stats["std"] - math.sqrt(ss_ / n_px - mean * mean))
              < 1e-12, f"[cli] 8. stats {stats}")
        print(f"[cli] 8. preprocess: {len(files)} images "
              f"({times['preprocess']:.2f} s) = batch_scan_to_bev on the "
              f"card, bit for bit; stats {json.dumps(stats)}")

        # 9. match-submap: scan 0's BEV placed in scan 1's grid
        traj = eval_trajectory()
        lines, times["match-submap"] = cli_call(
            ["match-submap", "--grid", os.path.join(p["imgs"], "000001.npz"),
             "--scan", os.path.join(p["imgs"], "000000.npz"), "--config",
             p["cfg.json"], "--rotations", CLI_ROTATIONS])
        got = json.loads(lines[-1])
        gt = relative_xy_yaw(traj[0], traj[1])
        dx, dy = (abs(got["pose_xy_yaw"][i] - gt[i]) for i in (0, 1))
        dyaw = abs(got["pose_xy_yaw"][2] - gt[2])
        step = 2 * math.pi / CLI_ROTATIONS
        check(dx <= cfg.bev.resolution and dy <= cfg.bev.resolution
              and dyaw <= step, f"[cli] 9. match-submap {got}, truth "
              f"{gt}")
        print(f"[cli] 9. match-submap: {json.dumps(got)}; truth "
              f"({gt[0]:.4f}, {gt[1]:.4f}, {gt[2]:.6f}): within "
              f"({dx:.3f}, {dy:.3f}) m and {dyaw:.5f} rad (bounds one cell "
              f"{cfg.bev.resolution} m, one step {step:.5f} rad); "
              f"{times['match-submap']:.2f} s")

        # 10. cluster, then train --init-centroids (host stats: K1)
        _, times["cluster"] = cli_call(
            ["cluster", "--split", p["split.npz"], "--out", p["cents.npz"],
             "--config", p["cfg_train.json"], "--num-images", 8,
             "--per-image", 100])
        with np.load(p["cents.npz"]) as d:
            check(d["centroids"].shape == (cfg.model.num_clusters,
                                           cfg.model.encoder_dim)
                  and d["descriptors"].shape == (800, cfg.model.encoder_dim),
                  "[cli] 10. cluster file shapes")
        reset_launches(ss.segment_sum_sorted)
        lines, times["train"] = cli_call(
            ["train", "--split", p["split.npz"], "--workdir", p["train"],
             "--config", p["cfg_train.json"], "--init-centroids",
             p["cents.npz"], "--host-stats"])
        n = launches_of(ss.segment_sum_sorted)
        k1 += n
        got = json.loads(lines[-1])
        ckpts = sorted(f for f in os.listdir(p["train"])
                       if f.startswith("ckpt_") and f.endswith(".pt"))
        check(set(got) == {"best_recall5", "epochs"} and got["epochs"] == 1
              and "ckpt_latest.pt" in ckpts and n > 0,
              f"[cli] 10. train {got}, {ckpts}, K1 {n}")
        print(f"[cli] 10. cluster ({times['cluster']:.2f} s) then train "
              f"--init-centroids --host-stats, one epoch "
              f"({times['train']:.2f} s): {json.dumps(got)}, wrote "
              f"{ckpts}, K1 launches {n}")

        # 11. eval --registration --host-stats = evaluate_split
        from gloc3d_tpu_torch.eval.evaluator import evaluate_split

        reset_launches(ss.segment_sum_sorted)
        lines, times["eval"] = cli_call(
            ["eval", "--split", p["split.npz"], *common, "--registration",
             "--host-stats", "--workdir", p["eval"], "--batch", CLI_BATCH])
        k1 += launches_of(ss.segment_sum_sorted)
        got = json.loads("\n".join(lines))
        want = json.loads(evaluate_split(
            GlobalLocalizer(cfg, served, device=dev, host_stats=True),
            kitti.load_split_scans(split, n_pad), batch=CLI_BATCH).to_json())
        for key in ("recognition_recall", "failed_detect_indices",
                    "failed_registration_indices", "banded_success"):
            check(got[key] == want[key], f"[cli] 11. eval {key}: "
                  f"{got[key]} != {want[key]}")
        worst = max(abs(got["registration"][k] - v)
                    for k, v in want["registration"].items())
        check(worst <= 1e-4, f"[cli] 11. eval registration {worst:.3e}")
        print(f"[cli] 11. eval --registration --host-stats "
              f"({times['eval']:.2f} s) = evaluate_split in this process: "
              f"recall {got['recognition_recall']}, registration "
              f"{json.dumps(got['registration'])} (within {worst:.1e})")

        # 12. profiling.trace around one locate names K1's kernel
        loc = GlobalLocalizer(cfg, served, device=dev, host_stats=True)
        loc.load(p["idx_hs"])
        loc.locate(pts[0], mask[0])
        with trace(p["trace"]):
            loc.locate(pts[0], mask[0])
        with open(os.path.join(p["trace"], TRACE_FILE)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        k1_names = sorted(n for n in names if "segment_sum_sorted" in n)
        check(k1_names, f"[cli] 12. no K1 kernel in the trace "
              f"({len(names)} kernel names)")
        print(f"[cli] 12. profiling.trace around one locate: "
              f"{TRACE_FILE} names K1's kernels {k1_names[:2]} among "
              f"{len(names)} kernel names")
    seconds = time.perf_counter() - t_phase
    rec["seconds"] = {"phase": seconds, **times}
    print(f"[cli] K1 launches {k1} (cli, host-stats), K2 {k2} (cli, "
          f"aligned), K2 {k2_export} (exported program); phase wall time "
          f"{seconds:.1f} s")
    return rec, k1, k2, k2_export


# ---------------------------------------------------------------- [submap]
SUBMAP_EXTENT_M = 100.0   # tools/bench_submap.py: ±100 m, z in [-4, 4]
SUBMAP_SWEEPS = 10
SUBMAP_CROP = (128, 640)  # the matcher's 512² centre crop of the 768² BEV
SUBMAP_POINTS = 4096      # the virtual scan
SUBMAP_GT = (4.0, -2.0, 0.35)  # bench_submap.py's offset query, σ 0.10 m


def submap_sweeps(world, n_pts: int):
    """tools/bench_submap.py's ten sweeps, from the poses (1.5 i, 0.4 i) m
    at yaw 0.06 i, i < 10: the walled world's scan at each pose (scan_at,
    the full pad), moved into the frame of sweep 0 as bench_submap.py moves
    its scan; and the sweeps' origins."""
    sweeps, masks = [], []
    for i in range(SUBMAP_SWEEPS):
        pts, mask = scan_at(world, (1.5 * i, 0.4 * i, 0.06 * i), n_pts,
                            seed=300 + i)
        c, s = np.cos(0.06 * i), np.sin(0.06 * i)
        p = pts[:, :3].copy()
        p[:, 0] = c * pts[:, 0] - s * pts[:, 1] + 1.5 * i
        p[:, 1] = s * pts[:, 0] + c * pts[:, 1] + 0.4 * i
        sweeps.append(p)
        masks.append(mask)
    origins = np.array([[1.5 * i, 0.4 * i, 0.0]
                        for i in range(SUBMAP_SWEEPS)], np.float32)
    return sweeps, masks, origins


def offset_query(v, t, alpha, sigma, seed):
    """bench_submap.py's q = R_α⁻¹(v − t) plus N(0, σ) per coordinate:
    matching q against the map recovers (t, α)."""
    c, s = np.cos(alpha), np.sin(alpha)
    q = np.stack([c * (v[:, 0] - t[0]) + s * (v[:, 1] - t[1]),
                  -s * (v[:, 0] - t[0]) + c * (v[:, 1] - t[1])], 1)
    if sigma > 0:
        q = q + np.random.RandomState(seed).normal(0, sigma, q.shape)
    return q.astype(np.float32)


def same_optimum(torch, score_at, grid, pts, mask, got, want,
                 tol: float = 1e-5) -> bool:
    """The same score within tol, and the same pose or a score-tied one."""
    if abs(float(got.score) - float(want.score)) >= tol:
        return False
    if torch.allclose(got.pose.cpu(), want.pose.cpu(), atol=1e-5):
        return True
    refit = float(score_at(grid, pts, mask, got.pose.to(pts.device)))
    return abs(refit - float(want.score)) < tol


def fft_error_probe(torch, grid, vpts, vmask, thetas, coarse_factor=None):
    """cuFFT's correlation against a float64 direct sum on the card: the
    fine FFT at pad 1.5·size (or, with ``coarse_factor``, the coarse bound
    FFT at pad 1.5·size_c) over the batch ``thetas``, at 16 random shifts
    per rotation and at its maximum where that is alias-free
    (|t| < size/2). Returns the largest |FFT − direct| in counts."""
    import torch.nn.functional as F

    from gloc3d_tpu_torch.ops import scan_match as sm

    size = grid.log_odds.shape[0]
    probs = grid.probabilities()
    col, row = sm._cells(thetas, vpts, grid.origin_xy, grid.resolution)
    valid = ((vmask > 0)[None] & (row >= 0) & (row < size) & (col >= 0)
             & (col < size))
    if coarse_factor:  # the matcher's own bound grid and coarse cells
        target = sm._coarse_bounds(probs, coarse_factor)
        q = sm._coarse_cells(col, row, coarse_factor)
        col, row = q[..., 0], q[..., 1]
        size = (size - 1) // coarse_factor + 1
    else:
        target = probs
    n = target.shape[0]
    pad = size + size // 2
    ft = torch.fft.rfft2(F.pad(target, (0, pad - n, 0, pad - n)))
    counts = sm._scatter_counts(torch.stack([col, row], -1), valid, size,
                                out_size=pad)
    corr = sm._fft_corr(counts, ft, pad).reshape(len(thetas), -1)
    gen = torch.Generator(device=corr.device).manual_seed(0)
    half = size // 2
    shifts = torch.randint(-half + 1, half, (len(thetas), 16, 2),
                           generator=gen, device=corr.device)
    best = torch.stack(sm._decode_shift(corr.argmax(-1), pad), -1)
    shifts = torch.cat([shifts, best[:, None]], 1)            # (R, 17, 2)
    ok = (shifts.abs() < half).all(-1)
    ty, tx = shifts[..., 0:1], shifts[..., 1:2]
    rows_t, cols_t = row[:, None] + ty, col[:, None] + tx     # (R, 17, N)
    inb = (valid[:, None] & (rows_t >= 0) & (rows_t < n) & (cols_t >= 0)
           & (cols_t < n))
    flat = (rows_t * n + cols_t).clamp(0, n * n - 1)
    direct = torch.where(inb, target.reshape(-1).double()[flat],
                         0.0).sum(-1)
    got = corr.gather(1, (ty[..., 0] % pad) * pad + tx[..., 0] % pad)
    return float(torch.where(ok, (got.double() - direct).abs(), 0.0).max())


def phase_submap(torch, card, world, dev: str = "cuda",
                 extent=SUBMAP_EXTENT_M):
    """[submap], tools/bench_submap.py's workload: ``Submap3D.insert`` of
    bench.py's 122 480-pad scan (bench_query_scan) and of 10 sweeps of the
    walled world (submap_sweeps) into the dual grid (high 1000×1000×40 at
    0.2 m, low 400×400×16 at 0.5 m), ``project_to_bev`` of
    the 10-sweep high grid to 768², ``match_scan`` and ``match_scan_fast``
    on its 512² centre crop with a 4096-point virtual scan of sweep 0 at
    R = 64, 256 and the local R = 32 ±0.15 rad, fast against exhaustive at
    the Olson-bound R, ``match_full_submap(fallback="full")`` on the
    offset query, ``cmd_match_submap``'s composition (``scan_to_bev`` →
    ``bev_to_virtual_points`` → ``match_full_submap``), the cuFFT error
    probes, and card against CPU (one sweep's insert and projection,
    ``apply_odds`` and ``grid_to_points`` on the crop, bit for bit;
    ``match_scan`` at R = 64, the same optimum). bench.py's scan is uniform noise in a
    box: ten of them overlapped fill nearly every pixel of their footprint,
    and no query can be placed in such a map, so the map is built from
    the world's sweeps, which have walls."""
    from gloc3d_tpu_torch.config import BEVConfig
    from gloc3d_tpu_torch.ops import scan_match as sm
    from gloc3d_tpu_torch.ops.bev import scan_to_bev
    from gloc3d_tpu_torch.ops.occupancy import (
        ProbabilityGrid2D, Submap3D, grid_to_points)
    from gloc3d_tpu_torch.ops.refine import bev_to_virtual_points

    t_phase = time.perf_counter()
    cfg = BEVConfig(z_min=-4.0, z_max=4.0)
    res = cfg.resolution
    sweeps, masks, origins = submap_sweeps(world, 122480)
    out = {"card": card}

    def to_dev(a, d=dev):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    submap0 = Submap3D.create(cfg, extent_xy=extent, device=dev)
    hi, lo = submap0.high.log_odds.shape, submap0.low.log_odds.shape
    bench_pts, bench_mask = bench_query_scan(122480)
    p0, m0, o0 = to_dev(sweeps[0]), to_dev(masks[0]), to_dev(origins[0])
    pb, mb = to_dev(bench_pts[0, :, :3]), to_dev(bench_mask[0])

    def insert():
        return submap0.insert(p0, m0, origin=o0, cfg=cfg)

    out["insert_ms"] = cuda_ms(torch, insert, 10)
    out["insert_bench_scan_ms"] = cuda_ms(
        torch, lambda: submap0.insert(pb, mb, cfg=cfg), 10)
    out["insert_syncs"] = count_syncs(torch, insert)
    busy, wall, n_kernels, _ = device_idle_share(torch, insert)
    out.update(insert_busy_ms=busy, insert_traced_wall_ms=wall,
               insert_kernels=n_kernels)
    one = insert()
    img0, org0 = one.project(cfg)
    sub = submap0
    for p, m, o in zip(sweeps, masks, origins):
        sub = sub.insert(to_dev(p), to_dev(m), origin=to_dev(o), cfg=cfg)
    torch.cuda.synchronize()
    known = int(sub.high.known.sum())
    print(f"[submap] on {card}: grids high {tuple(hi)} at {res} m, low "
          f"{tuple(lo)} at {cfg.low_resolution} m; Submap3D.insert (both "
          f"grids, one 122480-pad sweep; CUDA events, mean of 10): world "
          f"sweep ({int(masks[0].sum())} points) {out['insert_ms']:.3f} ms, "
          f"bench.py's scan (100 000 points) "
          f"{out['insert_bench_scan_ms']:.3f} ms; {out['insert_syncs']} "
          f"host syncs; traced: busy {busy:.3f} ms of {wall:.3f} ms, "
          f"{n_kernels} kernels; {SUBMAP_SWEEPS} sweeps: {known} known "
          f"high-res cells")
    check(known > 0 and sub.num_range_data == SUBMAP_SWEEPS,
          "submap: the sweeps left no known cell")
    check(not bool(submap0.high.known.any()),
          "submap: insert changed the grid passed in")

    def project():
        return sub.project(cfg)

    out["project_ms"] = cuda_ms(torch, project, 10)
    img768, org768 = project()
    print(f"[submap] project_to_bev of the {SUBMAP_SWEEPS}-sweep high grid "
          f"({math.prod(hi)} cells) → {cfg.image_size}²: "
          f"{out['project_ms']:.3f} ms; {int((img768 < 0.5).sum())} "
          f"occupied pixels")

    # one sweep card vs CPU, bit for bit
    cpu0 = Submap3D.create(cfg, extent_xy=extent, device="cpu").insert(
        torch.from_numpy(sweeps[0]), torch.from_numpy(masks[0]),
        origin=torch.from_numpy(origins[0]), cfg=cfg)
    cimg, corg = cpu0.project(cfg)
    same = (torch.equal(one.high.log_odds.cpu(), cpu0.high.log_odds)
            and torch.equal(one.high.known.cpu(), cpu0.high.known)
            and torch.equal(one.low.log_odds.cpu(), cpu0.low.log_odds)
            and torch.equal(one.low.known.cpu(), cpu0.low.known))
    same_img = (torch.equal(img0.cpu(), cimg)
                and torch.equal(org0.cpu(), corg))
    print(f"[submap] one sweep card vs CPU: both grids' log-odds and "
          f"known bit-equal {same}; projection bit-equal {same_img}")
    check(same, "submap: the card's insert differs from the CPU's")
    check(same_img, "submap: the card's projection differs from the CPU's")

    a, b = SUBMAP_CROP
    grid = ProbabilityGrid2D.from_bev_image(
        img768[a:b, a:b], org768 + a * res, res)
    occ = np.argwhere(img0.cpu().numpy() < 0.5)
    sel = np.random.RandomState(0).choice(len(occ), SUBMAP_POINTS,
                                          replace=len(occ) < SUBMAP_POINTS)
    vscan = (occ[sel][:, ::-1] * res + org0.cpu().numpy()[None, :]
             ).astype(np.float32)
    vpts, vmask = to_dev(vscan), torch.ones(SUBMAP_POINTS, device=dev)

    # the 2-D updates card vs CPU, bit for bit: a hit update at the virtual
    # scan's cells (repeats and off-grid cells among them) on the crop, and
    # its occupied cells as a virtual cloud
    cgrid = ProbabilityGrid2D(grid.log_odds.cpu(), grid.known.cpu(),
                              grid.origin_xy.cpu(), res)
    cells = np.round((vscan - (org768.cpu().numpy() + a * res)) / res
                     ).astype(np.int64)
    rows_c, cols_c = torch.from_numpy(cells[:, 1]), torch.from_numpy(
        cells[:, 0])
    ok_c = torch.from_numpy(np.arange(SUBMAP_POINTS) % 7 != 0)
    hit = grid.apply_odds(rows_c.to(dev), cols_c.to(dev), ok_c.to(dev), 0.55)
    chit = cgrid.apply_odds(rows_c, cols_c, ok_c, 0.55)
    gp = grid_to_points(hit.probabilities(), hit.origin_xy, res,
                        max_points=8192)
    cgp = grid_to_points(chit.probabilities(), chit.origin_xy, res,
                         max_points=8192)
    same_odds = (torch.equal(hit.log_odds.cpu(), chit.log_odds)
                 and torch.equal(hit.known.cpu(), chit.known))
    same_pts = all(torch.equal(x.cpu(), y) for x, y in zip(gp, cgp))
    off = int(((cells < 0) | (cells >= b - a)).any(1).sum())
    print(f"[submap] card vs CPU on the {b - a}² grid: apply_odds "
          f"({int(ok_c.sum())} of {SUBMAP_POINTS} lanes valid, {off} "
          f"off the grid) bit-equal {same_odds}; grid_to_points "
          f"({int(gp[1].sum())} points) bit-equal {same_pts}")
    check(same_odds, "submap: the card's apply_odds differs from the CPU's")
    check(same_pts, "submap: the card's grid_to_points differs from the "
          "CPU's")
    out["card_vs_cpu_bit_equal"] = (same and same_img and same_odds
                                    and same_pts)

    rows = {}
    for tag, nrot, hw in (("R=64", 64, math.pi), ("R=256", 256, math.pi),
                          ("local R=32 ±0.15 rad", 32, 0.15)):
        def exact(nrot=nrot, hw=hw):
            return sm.match_scan(grid, vpts, vmask, num_rotations=nrot,
                                 angular_halfwidth=hw)

        def fast(nrot=nrot, hw=hw):
            return sm.match_scan_fast(grid, vpts, vmask, num_rotations=nrot,
                                      angular_halfwidth=hw)

        e_ms, f_ms = cuda_ms(torch, exact, 5), cuda_ms(torch, fast, 5)
        e, (fr, cert) = exact(), fast()
        cert = bool(cert)
        agree = same_optimum(torch, sm.score_at, grid, vpts, vmask, fr, e)
        rows[tag] = {"match_scan_ms": e_ms, "match_scan_fast_ms": f_ms,
                     "certified": cert, "same_optimum": agree,
                     "score": float(e.score),
                     "pose": [float(x) for x in e.pose.cpu()]}
        pose = e.pose.cpu().numpy()
        print(f"[submap] {tag} on the {b - a}² grid, {SUBMAP_POINTS} points:"
              f" match_scan {e_ms:.3f} ms, match_scan_fast {f_ms:.3f} ms; "
              f"pose ({pose[0]:+.2f}, {pose[1]:+.2f}, "
              f"{math.degrees(pose[2]):+.2f}°) score {float(e.score):.4f}; "
              f"fast certified {cert}, same optimum {agree}")
        check(not cert or agree, f"submap {tag}: a certified fast result "
              "is not the exhaustive optimum")
    out["match"] = rows

    # match_scan at R = 64 card vs CPU
    want = sm.match_scan(cgrid, vpts.cpu(), vmask.cpu(), num_rotations=64)
    got = sm.match_scan(grid, vpts, vmask, num_rotations=64)
    agree = same_optimum(torch, sm.score_at, cgrid, vpts.cpu(), vmask.cpu(),
                         got, want)
    print(f"[submap] match_scan R=64 card vs CPU: scores "
          f"{float(got.score):.6f} / {float(want.score):.6f}, same "
          f"optimum {agree}")
    check(agree, "submap: the card's match_scan optimum differs from the "
          "CPU's")

    # the Olson-bound rotation count at the virtual scan's range
    r_max = float(np.linalg.norm(vscan, axis=1).max())
    step = sm.olson_angular_step(res, r_max)
    n_rot = int(math.ceil(2 * math.pi / step))
    k = max(128, min(n_rot, 2048))
    q0 = to_dev(offset_query(vscan, SUBMAP_GT[:2], SUBMAP_GT[2], 0.10, 100))

    def olson_fast():
        return sm.match_scan_fast(grid, q0, vmask, num_rotations=n_rot,
                                  num_candidates=k)

    def olson_exact():
        return sm.match_scan(grid, q0, vmask, num_rotations=n_rot)

    of_ms, oe_ms = cuda_ms(torch, olson_fast, 3), cuda_ms(torch, olson_exact,
                                                          3)
    (ofr, ocert), oe = olson_fast(), olson_exact()
    o_agree = same_optimum(torch, sm.score_at, grid, q0, vmask, ofr, oe)
    out["olson"] = {"r_max_m": r_max, "step_rad": step, "rotations": n_rot,
                    "num_candidates": k, "fast_ms": of_ms,
                    "exhaustive_ms": oe_ms, "certified": bool(ocert),
                    "same_optimum": o_agree,
                    "fast_score": float(ofr.score),
                    "exhaustive_score": float(oe.score)}
    print(f"[submap] Olson bound at r_max {r_max:.1f} m: dθ "
          f"{math.degrees(step):.4f}°, R = {n_rot}; offset query: "
          f"match_scan_fast (K={k}) {of_ms:.3f} ms, certified "
          f"{bool(ocert)}, score {float(ofr.score):.4f}; exhaustive "
          f"{oe_ms:.3f} ms ({-(-n_rot // sm.rotation_chunk_for(
              (b - a) * 3 // 2))} FFT batches), score {float(oe.score):.4f}; same optimum {o_agree}")
    check(not bool(ocert) or o_agree, "submap Olson R: a certified fast "
          "result is not the exhaustive optimum")

    def gt_err(pose, n):
        p = pose.cpu().numpy()
        dyaw = math.remainder(float(p[2]) - SUBMAP_GT[2], 2 * math.pi)
        return (abs(p[0] - SUBMAP_GT[0]), abs(p[1] - SUBMAP_GT[1]),
                abs(dyaw), 2 * math.pi / n)

    def check_gt(tag, pose, n):
        ex, ey, eyaw, dth = gt_err(pose, n)
        ok = ex <= res + 1e-4 and ey <= res + 1e-4 and eyaw <= dth + 1e-6
        print(f"[submap] {tag}: error ({ex:.3f}, {ey:.3f}) m, "
              f"{math.degrees(eyaw):.4f}° (gates one cell {res} m, one "
              f"step {math.degrees(dth):.4f}°)")
        check(ok, f"submap {tag}: the offset query was not recovered")
        return [float(ex), float(ey), float(eyaw)]

    def full_submap():
        return sm.match_full_submap(grid, q0, vmask, fallback="full")

    fs_ms = host_ms(torch, full_submap, 3)
    fs = full_submap()
    n_fs = int(math.ceil(2 * math.pi / sm.olson_angular_step(res, 50.0)))
    busy, wall, n_kernels, _ = device_idle_share(torch, full_submap)
    out["full_submap"] = {
        "ms": fs_ms, "rotations": n_fs, "certified": fs.certified,
        "used_fallback": fs.used_fallback, "score": float(fs.score),
        "busy_ms": busy, "traced_wall_ms": wall, "kernels": n_kernels,
        "gt_error": check_gt(
            f"match_full_submap(fallback='full'), R = {n_fs}, host "
            f"{fs_ms:.3f} ms, certified {fs.certified}, fallback "
            f"{fs.used_fallback}, traced busy {busy:.3f} of {wall:.3f} ms "
            f"({n_kernels} kernels)", fs.pose, n_fs)}

    # cmd_match_submap: a raw query scan → its BEV → a virtual scan → match
    c, s = math.cos(SUBMAP_GT[2]), math.sin(SUBMAP_GT[2])
    q3 = sweeps[0].copy()
    dx, dy = sweeps[0][:, 0] - SUBMAP_GT[0], sweeps[0][:, 1] - SUBMAP_GT[1]
    q3[:, 0], q3[:, 1] = c * dx + s * dy, -s * dx + c * dy

    def composed():
        bev = scan_to_bev(to_dev(q3), m0, cfg)
        pts, valid = bev_to_virtual_points(bev.image, bev.origin_xy, res,
                                           SUBMAP_POINTS)
        return sm.match_full_submap(grid, pts, valid, fallback="full")

    cm_ms = host_ms(torch, composed, 3)
    cm = composed()
    out["composed"] = {"ms": cm_ms, "score": float(cm.score),
                       "gt_error": check_gt(
                           f"cmd_match_submap composition, host "
                           f"{cm_ms:.3f} ms, score {float(cm.score):.4f}",
                           cm.pose, n_fs)}

    # cuFFT against float64 direct sums at the phase's shapes: the fine FFT
    # over one default batch of Olson rotations, the coarse bound FFT over
    # all of them in one batch
    thetas = sm.rotation_grid(n_rot, 0.0, math.pi, dev)
    size = b - a
    size_c = (size - 1) // 4 + 1
    pad, pad_c = size + size // 2, size_c + size_c // 2
    chunk, chunk_c = sm.rotation_chunk_for(pad), sm.rotation_chunk_for(pad_c)
    fine = fft_error_probe(torch, grid, q0, vmask, thetas[:chunk])
    coarse = fft_error_probe(torch, grid, q0, vmask, thetas[:chunk_c],
                             coarse_factor=4)
    out["fft_error_counts"] = {"fine": fine, "coarse": coarse}
    print(f"[submap] cuFFT vs float64 direct sums: fine (pad {pad}, batch "
          f"{min(chunk, n_rot)}) max {fine:.2e} counts, coarse (pad {pad_c}, "
          f"batch {min(chunk_c, n_rot)}) max {coarse:.2e} counts; the "
          f"certificate's slack is 0.05")
    check(max(fine, coarse) < 0.05, "submap: cuFFT error reaches the "
          "certificate slack")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[submap] phase {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------ kernel-only times
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores


def least_ms(n_bytes: float, n_ops: float):
    """The least time the card could take for work that moves ``n_bytes``
    and does ``n_ops`` fp32 operations: (ms, "bytes" or "operations")."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else \
        "operations"


def k1_work(x, starts):
    """K1's bytes (values and starts read once, sums written once) and
    adds."""
    b, n, c = x.shape
    v = starts.shape[-1] - 1
    return 4 * (b * n * c + b * (v + 1) + b * v * c), b * n * c


def k2_work(x, ids, v):
    """K2's bytes (features and ids read once, sums and counts written
    once) and adds."""
    b, n, c = x.shape
    return 4 * (b * n * c + b * n + b * v * c + b * v), b * n * (c + 1)


def kernel_device_ms(torch, fn, frag: str, iters: int, flush=None,
                     per_call: int = 2, attempts: int = 6):
    """Device time per call of fn() spent in kernels whose name holds
    ``frag`` and in memsets (the C entries' own), from a complete
    torch.profiler trace of ``iters`` calls (after three untraced ones):
    the wrapper's host work and its checks are out of it. With ``flush``
    the L2 cache is overwritten (by an add, a kernel of another name)
    before each call. A trace is complete when it holds ``per_call``
    operation names (K1: two kernels and a memset a call, K2: four
    kernels), each ``iters`` times.
    A trace's first events now and then go missing (late in a full smoke
    more often), so each trace records a second run of the calls after a
    profiler warm-up run (``schedule(warmup=1, active=1)``), and up to
    ``attempts`` traces are taken, with the CPU side traced and not in
    turns. Returns (ms per call, {kernel name: ms per call}), or (None,
    kernels kept per call in the fullest trace) when no trace was
    complete."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    kept = 0.0
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if attempt % 2 == 0 else []),
                schedule=schedule(wait=0, warmup=1, active=1,
                                  repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    if flush is not None:
                        flush.add_(1)
                    fn()
                torch.cuda.synchronize()
                prof.step()
        seen = {}
        for e in trace_events(prof):
            if (e.get("cat") == "kernel" and frag in e.get("name", "")
                    or e.get("cat") == "gpu_memset"):
                total, count = seen.get(e["name"], (0.0, 0))
                seen[e["name"]] = (total + e.get("dur", 0), count + 1)
        kept = max(kept, sum(c for _, c in seen.values()) / iters)
        if len(seen) == per_call and all(c == iters
                                         for _, c in seen.values()):
            by_name = {name: total / iters / 1e3
                       for name, (total, _) in seen.items()}
            return sum(by_name.values()), by_name
        print(f"[kernel-times] an incomplete trace of *{frag}*: "
              f"{len(seen)} operation names, {kept:g} of {per_call} "
              f"operations a call kept")
    return None, kept


def segment_reduce_call(torch, x, starts):
    """K1's function as one PyTorch call, for its time only (the port never
    calls it): ``torch.segment_reduce`` over the batch flattened into one
    row axis, every item's offsets shifted by its first row."""
    b, n, c = x.shape
    check(bool((starts[:, -1] == n).all()), "segment_reduce_call needs "
          "every row in a segment")
    offs = torch.cat([
        (starts[:, :-1].long()
         + n * torch.arange(b, device=x.device)[:, None]).reshape(-1),
        torch.tensor([b * n], device=x.device)])
    flat = x.reshape(b * n, c)
    v = starts.shape[-1] - 1
    return lambda: torch.segment_reduce(
        flat, "sum", offsets=offs, axis=0, unsafe=True).reshape(b, v, c)


def index_add_call(torch, x, ids, v):
    """K2's function as PyTorch calls, for their time only (the port never
    calls them): an fp32 ``index_add_`` into zeroed sums and a
    ``bincount`` over batch-offset ids."""
    b, n, c = x.shape
    flat = (ids.long() + v * torch.arange(b, device=x.device)[:, None]
            ).reshape(-1)
    rows = x.reshape(b * n, c)

    def call():
        sums = torch.zeros((b * v, c), device=x.device).index_add_(
            0, flat, rows)
        return (sums.reshape(b, v, c),
                torch.bincount(flat, minlength=b * v).reshape(b, v))
    return call


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def k2_earlier_launch(torch, source: str):
    """An earlier K2 source with the same C entry, for its times only:
    built with the port's nvcc flags into the build directory, loaded
    through ctypes; returns launch(features (B, N, C), ids, V)."""
    import ctypes
    import hashlib
    import subprocess

    from gloc3d_tpu_torch.kernels import build

    src = os.path.abspath(source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(build.BUILD_DIR, f"libk2_earlier_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                             capture_output=True, text=True, timeout=600)
        check(out.returncode == 0, f"nvcc failed on {source}: "
              f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    lib = ctypes.CDLL(so)
    fn = lib.gloc3d_pillar_bin_sums
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    size = lib.gloc3d_pillar_bin_sums_scratch_bytes
    size.restype = ctypes.c_int64
    size.argtypes = [ctypes.c_int64] * 4

    def launch(x, ids, v):
        b, n, c = x.shape
        sums = torch.empty((b, v, c), device=x.device)
        cnt = torch.empty((b, v), device=x.device)
        scratch = torch.empty(size(b, n, v, c), dtype=torch.uint8,
                              device=x.device)
        rc = fn(x.data_ptr(), ids.data_ptr(), sums.data_ptr(),
                cnt.data_ptr(), scratch.data_ptr(), b, n, v, c,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{source}: CUDA error {rc}")
        return sums, cnt
    return launch


def phase_kernel_times(torch, card, k1_cases, k2_cases, k2_earlier=None):
    """Each kernel alone at the main path's and the train step's shapes:
    its device time from a complete torch.profiler trace (L2-warm and
    L2-flushed, mean of 20 calls each), beside its bound, the wrapper's and
    the plain version's time (CUDA events, L2-warm; K2's wrapper with and
    without its read of the kernel's status, and the read alone), and the
    time of the PyTorch call that computes the same function (K1:
    ``torch.segment_reduce``; K2: fp32 ``index_add_`` + ``bincount``), held
    once to the plain version first. ``k2_earlier`` = (source, launch,
    operations a call) times an earlier K2 in turns with the current one
    (earlier, current, current, earlier), after holding it once to the
    plain version."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kinds = {
        "K1": (ss._launch, ss.segment_sum_sorted, segment_reduce_call,
               k1_work, "segment_sum_sorted", k1_cases),
        "K2": (bs._launch, bs.pillar_bin_sums, index_add_call, k2_work,
               "pillar_bin_sums", k2_cases),
    }
    out = {}
    for key, (launch, wrapper, library, work, frag, cases) in kinds.items():
        out[key] = {}
        for label, args in cases.items():
            lib_fn = library(torch, *args)
            got = lib_fn()
            plain = (ss.segment_sum_sorted_plain if key == "K1"
                     else lambda *a: bs.pillar_bin_sums_plain(*a)[0])
            want, l1 = plain(*args), plain(args[0].abs(), *args[1:])
            if key == "K2":
                check(torch.equal(got[1].float(),
                                  bs.pillar_bin_sums_plain(*args)[1]),
                      f"{key} library call {label}: counts differ")
                got = got[0]
            lib_err = float(((got - want).double().abs()
                             / l1.double().clamp_min(1e-30)).max())
            # an fp32 scatter drifts on pillar 0's ~82 000 rows (the plain
            # version accumulates in fp64): a sanity bound, not a tolerance
            check(lib_err < 1e-3, f"{key} library call {label} disagrees "
                  f"with the plain version: {lib_err:.3e} of L1 mass")
            per_call = 3 if key == "K1" else 4
            earlier = k2_earlier if key == "K2" else None
            if earlier is not None:
                src, old_launch, old_ops = earlier
                old_sums, old_cnt = old_launch(*args)
                old_err = float(((old_sums - want).double().abs()
                                 / l1.double().clamp_min(1e-30)).max())
                check(old_err < 1e-5 and torch.equal(
                    old_cnt, bs.pillar_bin_sums_plain(*args)[1]),
                    f"{src} {label} disagrees with the plain version")
                turns = []
                for which in ("earlier", "current", "current", "earlier"):
                    fn_t = ((lambda: old_launch(*args)) if which == "earlier"
                            else (lambda: launch(*args)))
                    ops = old_ops if which == "earlier" else per_call
                    turns.append((which, kernel_device_ms(
                        torch, fn_t, frag, 20, flush, per_call=ops)[0],
                        kernel_device_ms(torch, fn_t, frag, 20,
                                         per_call=ops)[0]))
            warm = kernel_device_ms(torch, lambda: launch(*args), frag, 20,
                                    per_call=per_call)
            cold = kernel_device_ms(torch, lambda: launch(*args), frag, 20,
                                    flush, per_call=per_call)
            r = {"shape": list(args[0].shape),
                 "kernel_only_ms": cold[0], "kernel_only_warm_ms": warm[0],
                 "wrapper_ms": cuda_ms(torch, lambda: wrapper(*args), 50),
                 "library_ms": cuda_ms(torch, lib_fn, 20, flush),
                 "library_warm_ms": cuda_ms(torch, lib_fn, 50),
                 "plain_warm_ms": cuda_ms(torch, lambda: plain(*args), 5)}
            r["bound_ms"], r["bound_by"] = least_ms(*work(*args))
            extra = ""
            if key == "K2":
                r["wrapper_no_check_ms"] = cuda_ms(
                    torch, lambda: launch(*args), 50)
                status = launch(*args)[2]
                r["check_ms"] = cuda_ms(
                    torch, lambda: bs._check_status(status, *args[1:]), 50)
                extra = (f"; wrapper without its status read "
                         f"{r['wrapper_no_check_ms']:.4f} ms, the status "
                         f"read alone {r['check_ms']:.4f} ms")
            if earlier is not None:
                r["turns"] = turns
                olds = [t for t in turns if t[0] == "earlier"]
                news = [t for t in turns if t[0] == "current"]

                def mean(ts, i):
                    got = [t[i] for t in ts if t[i] is not None]
                    return sum(got) / len(got) if got else None
                r["earlier_kernel_only_ms"] = mean(olds, 1)
                r["earlier_kernel_only_warm_ms"] = mean(olds, 2)
                r["turns_kernel_only_ms"] = mean(news, 1)
                extra += (f"; in turns with {src} (earlier, current, "
                          f"current, earlier; L2-flushed / warm): " + ", ".join(
                              f"{w} {fmt_ms(c)} / {fmt_ms(h)}"
                              for w, c, h in turns))
            # K1's second launch adds the partials of blocks wholly inside
            # one segment; K2's last one gathers and adds the sorted rows
            second = "reduce" if key == "K2" else "partials"

            def timed(t, cache):
                return (f"{t[0]:.4f} ms {cache}" if t[0] is not None else
                        f"not measured {cache} (no complete trace in six: "
                        f"the fullest kept {t[1]:g} of {per_call} "
                        f"operations a call)")

            kernel = (f"kernel only {timed(cold, 'L2-flushed')} / "
                      f"{timed(warm, 'L2-warm')} (torch.profiler, all "
                      f"{per_call} device operations of every traced call)")
            if cold[0] is not None:
                r[f"{second}_ms"] = sum(ms for name, ms in cold[1].items()
                                        if second in name)
                # each launch by its name without the namespace and the
                # parameter list, e.g. pillar_bin_sums_wide<2, 1, true>
                r["by_kernel_ms"] = {
                    name.replace("(anonymous namespace)::", "").split("(")[0]
                    .removeprefix("void "): ms
                    for name, ms in cold[1].items()}
                kernel += (f", of it the {second} launch "
                           f"{r[f'{second}_ms']:.4f} ms flushed, "
                           f"{r['bound_ms'] / cold[0]:.1%} of the bound; "
                           f"by launch " + ", ".join(
                               f"{n} {ms:.4f}"
                               for n, ms in r["by_kernel_ms"].items()))
            print(f"[kernel-times] {key} {label} {tuple(args[0].shape)} on "
                  f"{card}: {kernel}; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); wrapper "
                  f"{r['wrapper_ms']:.4f} ms L2-warm{extra}; library call "
                  f"{r['library_ms']:.4f} ms L2-flushed / "
                  f"{r['library_warm_ms']:.4f} ms L2-warm (CUDA events; "
                  f"{lib_err:.1e} of L1 mass from the plain version); plain "
                  f"version {r['plain_warm_ms']:.4f} ms L2-warm")
            out[key][label] = r
    return out


# ------------------------------------------------------------------ [knn]
# H100 SXM float64 outside the tensor cores: 64 lanes a clock on each of
# 132 SMs at 1.98 GHz, one instruction a lane (the data sheet's 34 TFLOP/s
# counts a fused multiply-add as two). The float64 tensor cores are not
# counted: their product rounds in an order of its own, and the selection
# needs the plain version's distances bit for bit (csrc/knn_normals.cu).
FP64_INSTR_PER_S = 132 * 64 * 1.98e9
# a product, three fused multiply-adds, an add, the threshold comparison
KNN_PAIR_OPS = 6
KNN_SCANS = ((0.0, 0.0, 0.3), (10.0, -5.0, 1.2), (-20.0, 30.0, -0.7),
             (40.0, 10.0, 2.0), (-35.0, -25.0, 0.1), (5.0, 45.0, -1.5),
             (25.0, -40.0, 0.9), (-10.0, 15.0, 2.8))


def knn_inputs(torch, world, cfg, b: int, seed: int = 0):
    """The k-NN normals' arguments (points (B, M, 3) float64, ok (B, M),
    k) as the ground estimate passes them for b tilted scans of the world:
    recorded from ``estimate_ground_batch``, the call the localizer's
    ``_align`` makes, on the card."""
    from gloc3d_tpu_torch.ops.ground import estimate_ground_batch

    scans = [tilted_scan_at(world, pose, (0.03 * (i % 3 - 1), 0.02, 1.7),
                            cfg.voxel.max_points, seed + i)
             for i, pose in enumerate(KNN_SCANS[:b])]
    pts = torch.from_numpy(np.stack([s[0][:, :3] for s in scans])).cuda()
    mask = torch.from_numpy(np.stack([s[1] for s in scans])).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = record_launches(lambda: estimate_ground_batch(
        pts, mask, cfg.ground, gen))["KNN"]
    check(len(calls) == 1, f"[knn] the ground estimate of {b} scans "
          f"launched the k-NN normals {len(calls)} times")
    return calls[0]


def knn_chain(torch, pts, ok, k):
    """The k-NN PCA normals as the ground estimate ran them before the
    kernel (a (B, M, M) float64 matrix and torch.topk), for their time."""
    from gloc3d_tpu_torch.kernels.knn_normals import _smallest_eigvec_3x3

    rows = torch.arange(pts.shape[0], device=pts.device)[:, None]
    sq = torch.sum(pts * pts, -1)
    d2 = (sq[:, :, None] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
          + sq[:, None, :])
    d2 = torch.where(ok[:, None, :], d2, math.inf)
    nn = torch.topk(d2, k, dim=-1, largest=False).indices
    nbr = pts[rows[:, :, None], nn]
    c = nbr - nbr.mean(dim=2, keepdim=True)
    return _smallest_eigvec_3x3(
        torch.einsum("bmki,bmkj->bmij", c, c) / k)


def phase_knn(torch, cfg, world, card) -> dict:
    """[knn]: the k-NN normals kernel (csrc/knn_normals.cu) on the
    arguments the ground estimate passes it for real tilted scans at B = 1
    and 8 (record_launches): against its plain version (each row within
    its bound, check_knn), bit-equal over launches and a graph replay; then
    its kernel-only time (torch.profiler, L2-flushed / L2-warm, mean of
    20) beside the float64 bound, the wrapper's, the plain version's and
    the replaced chain's times (CUDA events)."""
    from gloc3d_tpu_torch.kernels import knn_normals as kn

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for b in (1, 8):
        pts, ok, k = knn_inputs(torch, world, cfg, b, seed=b)
        m = pts.shape[1]
        before = kn.knn_normals.launches
        err, share = check_knn(torch, f"[knn] ({b}, {m}, 3)", pts, ok, k)
        check(kn.knn_normals.launches == before + 1,
              "[knn] the wrapper did not launch the kernel")
        got = kn.knn_normals(pts, ok, k)
        chain_err = float((got - knn_chain(torch, pts, ok, k)).abs().max())
        again = {"launch": kn._launch(pts, ok, k)}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            again["graph replay"] = kn.knn_normals(pts, ok, k)
        graph.replay()
        torch.cuda.synchronize()
        diffs = {name: float((t - got).abs().max())
                 for name, t in again.items() if not torch.equal(t, got)}
        same = not diffs
        check(same, f"[knn] ({b}, {m}, 3): launches differ in their bits "
              f"(max |diff| {diffs})")
        ops = KNN_PAIR_OPS * b * m * m
        r = {"shape": [b, m, 3], "k": k, "max_abs_err": err,
             "worst_share_of_row_bound": share,
             "chain_max_abs_err": chain_err, "bit_equal": same,
             "bound_ms": ops / FP64_INSTR_PER_S * 1e3,
             "bound_by": "float64 operations",
             "bytes": 32 * b * m + 24 * b * m}
        frag = "knn_normals"
        warm = kernel_device_ms(torch, lambda: kn._launch(pts, ok, k), frag,
                                20, per_call=1)
        cold = kernel_device_ms(torch, lambda: kn._launch(pts, ok, k), frag,
                                20, flush, per_call=1)
        r["kernel_only_ms"], r["kernel_only_warm_ms"] = cold[0], warm[0]
        r["wrapper_ms"] = cuda_ms(torch, lambda: kn.knn_normals(pts, ok, k),
                                  50)
        r["plain_warm_ms"] = cuda_ms(
            torch, lambda: kn.knn_normals_plain(pts, ok, k), 5)
        r["chain_ms"] = cuda_ms(torch, lambda: knn_chain(torch, pts, ok, k),
                                20, flush)
        r["chain_warm_ms"] = cuda_ms(
            torch, lambda: knn_chain(torch, pts, ok, k), 20)
        of_bound = ("" if cold[0] is None else
                    f", {r['bound_ms'] / cold[0]:.1%} of the bound")
        print(f"[knn] ({b}, {m}, 3), k = {k}, the ground estimate's "
              f"arguments, on {card}: kernel against the plain version max "
              f"|diff| {err:.2e}, the worst row at {share:.2f} of its bound "
              f"({KNN_ULPS_PER_K} k eps lambda_max / eigenvalue gap), "
              f"against the replaced chain {chain_err:.2e}; bit-equal over "
              f"launches and a graph replay: {same}")
        print(f"[kernel-times] knn_normals ({b}, {m}, 3) on {card}: kernel "
              f"only {fmt_ms(cold[0])} L2-flushed / {fmt_ms(warm[0])} "
              f"L2-warm (torch.profiler, mean of 20){of_bound}; bound "
              f"{r['bound_ms']:.4f} ms (float64 operations: {KNN_PAIR_OPS} "
              f"a pair at {FP64_INSTR_PER_S / 1e12:.1f} T a second; "
              f"{r['bytes']} bytes); wrapper {r['wrapper_ms']:.4f} ms "
              f"L2-warm; plain version {r['plain_warm_ms']:.4f} ms L2-warm "
              f"(with its host read); the replaced chain (DGEMM, "
              f"elementwise passes, torch.topk) {r['chain_ms']:.4f} ms "
              f"L2-flushed / {r['chain_warm_ms']:.4f} ms L2-warm (CUDA "
              f"events)")
        out[f"B={b}"] = r
    return out


# -------------------------------------------------------------- training
def training_dataset(world, n: int):
    """A synthetic TripletDataset in the walled world: 24 db scans on a 6×4
    grid at 12 m spacing, 8 queries within 3 m of a db scan, random
    headings, every scan padded to n rows. Each query has a db scan within
    10 m (a nontrivial positive) and at least 15 beyond 20 m (negatives)."""
    from gloc3d_tpu_torch.data import dataset

    rng = np.random.RandomState(21)
    db_poses = [(x, y, rng.uniform(-np.pi, np.pi))
                for x in np.arange(6) * 12.0 - 30.0
                for y in np.arange(4) * 12.0 - 18.0]
    near = rng.choice(len(db_poses), N_TRAIN_Q, replace=False)
    q_poses = [(db_poses[j][0] + rng.uniform(-3, 3),
                db_poses[j][1] + rng.uniform(-3, 3),
                rng.uniform(-np.pi, np.pi)) for j in near]
    db = [scan_at(world, p, n, seed=500 + i) for i, p in enumerate(db_poses)]
    qs = [scan_at(world, p, n, seed=600 + i) for i, p in enumerate(q_poses)]
    ds = dataset.TripletDataset(
        db_inputs=np.stack([s[0] for s in db]),
        q_inputs=np.stack([s[0] for s in qs]),
        utm_db=np.array([p[:2] for p in db_poses]),
        utm_q=np.array([p[:2] for p in q_poses]),
        db_masks=np.stack([s[1] for s in db]),
        q_masks=np.stack([s[1] for s in qs]))
    check(bool(ds.nontrivial_positives(10.0).any(1).all())
          and int(ds.potential_negatives(20.0).sum(1).min()) >= 15,
          "training world: a query lacks a positive or negatives")
    return ds


def training_model(torch, cfg, ds, device, compute_dtype=None):
    """The trainable model (fold_bn=False): the port's seeded init, then
    NetVLAD initialised from the db scans' encoder features (the ported
    cluster mode)."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params
    from gloc3d_tpu_torch.train import init_vlad_from_data

    mc = cfg.model.replace(fold_bn=False)
    if compute_dtype is not None:
        mc = mc.replace(compute_dtype=compute_dtype)
    model = init_params(build_model(mc, cfg.voxel), seed=0).to(device)
    init_vlad_from_data(cfg.replace(model=mc), model, ds.db_inputs,
                        ds.db_masks, torch.Generator().manual_seed(0),
                        num_images=len(ds.db_inputs), per_image=100)
    return model


def timed(torch, fn, log):
    """fn with each call's CUDA-event ms appended to ``log`` (calls that
    return None, a skipped batch, are not logged)."""
    def wrapper(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        if out is not None:
            log.append((e0.elapsed_time(e1), len(args[0])))
        return out
    return wrapper


def check_train_launches(torch, path, launches, host_stats):
    """Hold every K1 / K2 launch recorded from one cache batch of 8 and one
    train step of 24 scans to the plain versions (record_launches)."""
    want = ({"K1": 2, "K2": 0, "KNN": 0} if host_stats
            else {"K1": 0, "K2": 4, "KNN": 0})
    got = {key: len(calls) for key, calls in launches.items()}
    check(got == want, f"{path}: recorded launches {got}, expected {want}")
    parts = []
    for key, calls in launches.items():
        for args in calls:
            rel = check_recorded(
                torch, f"{path} {key} {tuple(args[0].shape)}", key, args)
            parts.append(f"{key} {tuple(args[0].shape)} {rel:.2e}")
    print(f"[train] {path}: every kernel launch of one cache batch and one "
          f"train step against its plain version, error relative to L1 "
          f"mass (bound 1e-5"
          + ("" if host_stats else "; K2 counts exactly equal") + "): "
          + ", ".join(parts))


def phase_training(torch, cfg, ds, card):
    """On each train path at full width: one epoch (cache refresh and its
    steps: the main path, counted); the kernel launches of one cache batch
    and one step held to the plain versions; two epochs timed around the
    whole step only; the step's split in a separate pass; one traced
    step."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.train import Trainer

    dev = torch.device("cuda")
    tcfg = cfg.replace(model=cfg.model.replace(fold_bn=False),
                       train=cfg.train.replace(cache_refresh_rate=N_TRAIN_Q))
    b, n_neg = tcfg.train.batch_size, tcfg.train.n_neg
    cache_batches = sum(math.ceil(len(a) / 8)
                        for a in (ds.db_inputs, ds.q_inputs))
    counts = {}
    for host_stats in (False, True):
        path = "host-stats" if host_stats else "all-device"
        c = tcfg.replace(train=tcfg.train.replace(host_stats=host_stats))
        model = training_model(torch, c, ds, dev)
        with tempfile.TemporaryDirectory() as workdir:
            tr = Trainer(c, model, ds, workdir, device=dev)
            before = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
            torch.cuda.reset_peak_memory_stats()
            reset_launches(ss.segment_sum_sorted)
            reset_launches(bs.pillar_bin_sums)
            ss.segment_sum_sorted_grad.backward_calls = 0
            bs.pillar_bin_sums_grad.backward_calls = 0
            loss = tr.train_epoch(1)
            k1 = launches_of(ss.segment_sum_sorted)
            k2 = launches_of(bs.pillar_bin_sums)
            k1_bwd = ss.segment_sum_sorted_grad.backward_calls
            k2_bwd = bs.pillar_bin_sums_grad.backward_calls
            n_steps = tr.step
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[train] {path}: epoch 1 over {N_TRAIN_Q} queries "
                  f"(batch {b}, {b * (2 + n_neg)} clouds x "
                  f"{ds.db_inputs.shape[1]} points per step): {n_steps} "
                  f"steps, mean loss {loss:.5f}; launches K1 {k1}, K2 {k2}; "
                  f"backward calls K1 {k1_bwd}, K2 {k2_bwd}")
            check(n_steps >= 3, f"{path}: only {n_steps} train steps ran")
            check(math.isfinite(loss) and loss > 0, f"{path}: loss {loss}")
            want = ((0, 2 * (cache_batches + n_steps), 0, n_steps)
                    if not host_stats else
                    (cache_batches + n_steps, 0, n_steps, 0))
            check((k1, k2, k1_bwd, k2_bwd) == want,
                  f"{path}: (K1, K2, K1 backward, K2 backward) = "
                  f"{(k1, k2, k1_bwd, k2_bwd)}, expected {want}")
            zero = [k for k, p in model.named_parameters()
                    if k.startswith("encoder.") and (
                        p.grad is None or float(p.grad.abs().max()) == 0.0)]
            check(not zero, f"{path}: zero gradient for {zero}")
            same = [k for k, p in model.named_parameters()
                    if torch.equal(p.detach(), before[k])]
            check(not same, f"{path}: parameters unchanged: {same}")
            pn = model.encoder.pn.pointnet[0].weight.grad
            print(f"[train] {path}: all {len(before)} parameters changed; "
                  f"every encoder parameter has a nonzero gradient (PointNet "
                  f"weight max |grad| {float(pn.abs().max()):.3e}); peak "
                  f"device memory {peak:.2f} GiB on {card}")
            counts[path] = (k1, k2)

            cache_db = tr.compute_cache(ds.db_inputs, ds.db_masks)
            cache_q = tr.compute_cache(ds.q_inputs, ds.q_masks)

            def one_step():
                check(tr._train_batch(np.arange(b), cache_db, cache_q)
                      is not None, f"{path}: the probe batch took no step")

            check_train_launches(torch, path, record_launches(lambda: (
                tr.compute_cache(ds.db_inputs[:8], ds.db_masks[:8]),
                one_step())), host_stats)

            # the whole step and the cache refresh, timed from the outside
            # only: the step ends in the trainer's own sync (float(loss))
            steps, caches = [], []
            tr._train_batch = timed(torch, tr._train_batch, steps)
            tr.compute_cache = timed(torch, tr.compute_cache, caches)
            for epoch in (2, 3):
                tr.train_epoch(epoch)
            del tr._train_batch, tr.compute_cache
            step_ms = float(np.median([s[0] for s in steps]))
            cache_ms = sum(s[0] for s in caches) / sum(s[1] for s in caches)
            # the split, in a separate pass (its wrappers add syncs)
            inner, host = [], []
            inner_fn = "train_step_hs" if host_stats else "train_step"
            tr._host_sorted = timed(torch, tr._host_sorted, host)
            setattr(tr, inner_fn, timed(torch, getattr(tr, inner_fn), inner))
            for _ in range(3):
                one_step()
            del tr._host_sorted
            delattr(tr, inner_fn)
            dev_ms = float(np.median([s[0] for s in inner]))
            host_ms = float(np.median([s[0] for s in host])) if host else 0.0
            print(f"[train] {path} on {card}: {step_ms:.2f} ms per train "
                  f"step (mining, gather, "
                  f"{'host pass, ' if host_stats else ''}upload, forward, "
                  f"backward, SGD; CUDA events around the whole step only, "
                  f"median of {len(steps)} warm steps of epochs 2-3); split "
                  f"in a separate pass of 3 steps with syncs between the "
                  f"parts: {dev_ms:.2f} ms in "
                  f"{inner_fn}, "
                  f"{host_ms:.2f} ms in the host pass of the step's "
                  f"{b * (2 + n_neg)} scans; cache refresh {cache_ms:.3f} ms "
                  f"per scan ({sum(s[1] for s in caches)} scans in batches "
                  f"of 8)")
            busy, wall, n_k, by_class = device_idle_share(torch, one_step)
            print(f"[train] {path}: traced train step on {card}: device busy "
                  f"{busy:.2f} ms of {wall:.2f} ms wall, idle share "
                  f"{1 - busy / wall:.3f}, {n_k} kernels (torch.profiler; "
                  f"against the untraced {step_ms:.2f} ms the idle share is "
                  f"{1 - busy / step_ms:.3f}); device ms by class: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                      by_class.items(), key=lambda kv: -kv[1])))
    return counts


def train_kernel_inputs(torch, cfg, ds):
    """Both kernels' inputs at the train step's shape, from the first 24 db
    scans: K1's pillar-sorted ``ids`` and ``starts`` from the host pass; the
    device binning's ``vox`` (``points_to_voxels``: ids, raw counts, V) and
    its statistics ``payload`` (24, N, 4); random features ``x`` (24, N,
    64)."""
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.ops.voxelize import points_to_voxels

    dev = torch.device("cuda")
    vc = cfg.voxel
    b = cfg.train.batch_size * (2 + cfg.train.n_neg)
    pts, mask = ds.db_inputs[:b], ds.db_masks[:b]
    host = native.compute_voxel_stats_host_sorted(
        pts, mask.sum(1).astype(np.int64), vc.xbound, vc.ybound, vc.zbound,
        crop=False)
    ids, starts = (torch.from_numpy(host[i]).to(dev) for i in (2, 5))
    p_d = torch.from_numpy(pts).to(dev)
    m_d = torch.from_numpy(mask).to(dev)
    vox = points_to_voxels(p_d[..., :3], m_d, vc.xbound, vc.ybound,
                           vc.zbound)
    payload = torch.cat([vox["points_mask"][..., None], p_d[..., :3]],
                        dim=-1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, pts.shape[1], 64), generator=gen, device=dev)
    return {"ids": ids, "starts": starts, "vox": vox, "payload": payload,
            "x": x}


def phase_train_kernels(torch, cfg, ds, card):
    """Each kernel's autograd Function against autograd through its plain
    version, on the card at the train step's shape (24, 122480, 64) with
    real pillar layouts: K1 on the host pass's sorted ids, K2 on the device
    binning's ids. The forward per pillar relative to its L1 mass (bound
    1e-5), the gradient exactly (bound 1e-6), and both backward times."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.ops.voxelize import scatter_mean_to_grid

    dev = torch.device("cuda")
    t = train_kernel_inputs(torch, cfg, ds)
    ids, starts, vox, x = t["ids"], t["starts"], t["vox"], t["x"]
    b, v = x.shape[0], vox["num_voxels"]
    pts = ds.db_inputs[:b]
    gen = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn((b, v, 64), generator=gen, device=dev)
    cases = {
        "K1": (lambda t: ss.segment_sum_sorted_grad(t, starts, ids),
               lambda t: ss.segment_sum_sorted_plain(t, starts)),
        "K2": (lambda t: scatter_mean_to_grid(t, vox["voxel_indices"], v,
                                              counts=vox["raw_counts"]),
               lambda t: bs.pillar_bin_sums_plain(
                   t, vox["voxel_indices"], v)[0]
               / vox["raw_counts"].clamp_min(1.0)[..., None]),
    }
    out = {}
    for name, (kernel_fn, plain_fn) in cases.items():
        ys, grads, ms = [], [], []
        for fn in (kernel_fn, plain_fn):
            xr = x.clone().requires_grad_()
            y = fn(xr)
            check(y.grad_fn is not None, f"{name}: output has no grad_fn")
            (g,) = torch.autograd.grad(y, xr, w, retain_graph=True)
            ys.append(y.detach())
            grads.append(g)
            ms.append(cuda_ms(torch, lambda: torch.autograd.grad(
                y, xr, w, retain_graph=True), 20))
        with torch.no_grad():
            l1 = plain_fn(x.abs()).double()
        fwd = float(((ys[0] - ys[1]).double().abs()
                     / l1.clamp_min(1e-30)).max())
        err = float((grads[0] - grads[1]).abs().max())
        print(f"[train-kernels] {name} at ({b}, {pts.shape[1]}, 64) on "
              f"{card}: forward, autograd Function vs plain, max error "
              f"relative to per-pillar L1 mass {fwd:.3e} (bound 1e-5); "
              f"backward (row gather) vs autograd through the plain "
              f"version: max |diff| {err:.3e} (bound 1e-6); "
              f"{ms[0]:.4f} ms vs {ms[1]:.4f} ms (CUDA events, L2-warm, "
              f"mean of 20)")
        check(fwd < 1e-5, f"{name} forward at the train step's shape "
              f"disagrees with its plain version: {fwd:.3e}")
        check(err <= 1e-6, f"{name} backward disagrees with its plain "
              f"version: {err:.3e}")
        out[name] = (err, ms[0], ms[1])
    return out


def phase_train_reference(torch, cfg, ds, n_pts: int = 16384):
    """One fp32 train step on each path, card against CPU, from the same
    weights, batch, triplets and yaw, at a reduced pad (TF32 off).

    The loss must agree within rtol 1e-4. The gradient of one triplet step
    is chaotic at the ~1e-2 level in fp32 (rounding decides ReLUs near 0,
    and BatchNorm's mean subtraction cancels most of a weight gradient), so
    the smoke measures that floor where it brackets a change of device: the
    same step on the CPU with its mkldnn convolutions off against on (the
    same code, only the convolutions' summation order differs). Each
    tensor's card gradient must lie within twice that floor's worst tensor,
    over both paths, of its norm from the CPU's; a lost or mis-scaled
    gradient path is an O(1) error."""
    from gloc3d_tpu_torch.data import dataset
    from gloc3d_tpu_torch.models.descriptor import build_model
    from gloc3d_tpu_torch.train import Trainer
    from gloc3d_tpu_torch.train.trainer import rotate_clouds_z

    small = dataset.TripletDataset(
        db_inputs=np.ascontiguousarray(ds.db_inputs[:, :n_pts]),
        q_inputs=np.ascontiguousarray(ds.q_inputs[:, :n_pts]),
        utm_db=ds.utm_db, utm_q=ds.utm_q,
        db_masks=np.ascontiguousarray(ds.db_masks[:, :n_pts]),
        q_masks=np.ascontiguousarray(ds.q_masks[:, :n_pts]))
    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    dist = np.linalg.norm(small.utm_q[:b, None] - small.utm_db[None], axis=-1)
    pos = dist.argmin(1)
    neg = np.concatenate([np.flatnonzero(d > 20.0)[:n_neg] for d in dist])
    yaw = torch.tensor(np.random.RandomState(4).uniform(-np.pi, np.pi, b),
                       dtype=torch.float32)
    q_in = rotate_clouds_z(torch.from_numpy(small.q_inputs[:b]), yaw).numpy()
    clouds = (q_in, small.db_inputs[pos], small.db_inputs[neg])
    masks = (small.q_masks[:b], small.db_masks[pos], small.db_masks[neg])
    nv, qv = np.ones((b, n_neg), np.float32), np.ones(b, np.float32)
    init = training_model(torch, cfg, small, "cuda", "float32").state_dict()
    c = cfg.replace(model=cfg.model.replace(fold_bn=False,
                                            compute_dtype="float32"))

    def step(device, host_stats, mkldnn=True):
        model = build_model(c.model, c.voxel)
        model.load_state_dict(init)
        cc = c.replace(train=c.train.replace(host_stats=host_stats))
        torch.backends.mkldnn.enabled = mkldnn
        try:
            with tempfile.TemporaryDirectory() as workdir:
                tr = Trainer(cc, model, small, workdir, device=device)
                if host_stats:
                    loss = tr.train_step_hs(*tr._host_sorted(
                        np.concatenate(clouds), np.concatenate(masks)),
                        nv, qv)
                else:
                    loss = tr.train_step(clouds[0], masks[0], clouds[1],
                                         masks[1], clouds[2], masks[2], nv,
                                         qv)
        finally:
            torch.backends.mkldnn.enabled = True
        return float(loss), {k: p.grad.detach().cpu()
                             for k, p in model.named_parameters()}

    runs = {}
    for host_stats in (False, True):
        path = "host-stats" if host_stats else "all-device"
        (l_g, g_g), (l_c, g_c) = step("cuda", host_stats), step("cpu",
                                                                 host_stats)
        _, g_o = step("cpu", host_stats, mkldnn=False)
        runs[path] = (l_g, l_c, g_g, g_c, grad_floor(g_c, g_o))
    floor = max(r[-1] for r in runs.values())
    for path, (l_g, l_c, g_g, g_c, _) in runs.items():
        print(f"[train-reference] {path}, fp32 step at {n_pts} points, card "
              f"vs CPU: loss {l_g:.7f} vs {l_c:.7f} (rel "
              f"{abs(l_g - l_c) / abs(l_c):.2e}, bound 1e-4)")
        check(abs(l_g - l_c) <= 1e-4 * abs(l_c), f"{path}: card loss "
              f"{l_g} vs CPU {l_c}")
        grad_floor_check(f"train-reference, {path}", g_g, g_c, floor,
                         "mkldnn convolutions off vs on, over both paths")


# ------------------------------------------------- i2i and pose training
def grad_rel(a, b):
    """Per tensor, |a - b| / |b| of two gradient dicts."""
    return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
            for k in b}


def grad_floor(cpu_grads, *reruns):
    """The CPU's own floor: the worst tensor of the CPU reruns that change
    only an order of summation, against the CPU's step."""
    return max(max(grad_rel(g, cpu_grads).values()) for g in reruns)


def grad_floor_check(tag, card_grads, cpu_grads, floor, floor_what):
    """Hold a card step's gradients to the CPU's: each tensor's |diff| /
    |grad| within twice ``floor``. Returns the worst card-vs-CPU tensor."""
    cross = grad_rel(card_grads, cpu_grads)
    worst = sorted(cross, key=cross.get)[-3:]
    print(f"[{tag}] gradient |diff| / |grad| per tensor, card vs CPU, "
          f"worst: " + ", ".join(f"{k} {cross[k]:.2e}" for k in worst)
          + f" (median {np.median(list(cross.values())):.2e}); the CPU "
          f"with {floor_what}: worst {floor:.2e} (bound {2 * floor:.2e}, "
          f"twice that floor)")
    check(max(cross.values()) <= 2 * floor, f"{tag}: card gradients differ "
          f"from the CPU's by {max(cross.values()):.3e}, more than twice the "
          f"CPU's own floor {floor:.3e}")
    return max(cross.values())


def i2i_training_dataset(torch, cfg, world):
    """The training world's 24 db and 8 query scans (training_dataset)
    rendered by the port to 768² BEV images: the i2i inputs a user loads
    from disk."""
    from gloc3d_tpu_torch.data import dataset

    scans = training_dataset(world, cfg.voxel.max_points)
    db, _ = render_bevs(torch, cfg, list(zip(scans.db_inputs,
                                             scans.db_masks)))
    qs, _ = render_bevs(torch, cfg, list(zip(scans.q_inputs,
                                             scans.q_masks)))
    return dataset.TripletDataset(db_inputs=db, q_inputs=qs,
                                  utm_db=scans.utm_db, utm_q=scans.utm_q)


def i2i_trainer(torch, cfg, ds, workdir, device, seed=0, vlad_from=None):
    """A seeded image model (NetVLAD initialised from ``vlad_from``, the db
    images by default) in a Trainer with the reference's freeze mask."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params
    from gloc3d_tpu_torch.models.encoders import train_mask
    from gloc3d_tpu_torch.train import Trainer, init_vlad_from_data

    model = init_params(build_model(cfg.model, cfg.voxel), seed=seed)
    model = model.to(device)
    images = ds.db_inputs if vlad_from is None else vlad_from
    init_vlad_from_data(cfg, model, images, None,
                        torch.Generator().manual_seed(seed),
                        num_images=len(images), per_image=100)
    mask = train_mask(model, cfg.model.encoder)
    return Trainer(cfg, model, ds, workdir, device=device,
                   trainable_mask=mask), mask


def check_freeze(torch, tag, model, mask, before):
    """Frozen parameters bit-unchanged; every trainable one has a nonzero
    gradient and moved."""
    params = dict(model.named_parameters())
    moved = [k for k, t in mask.items() if not t
             and not torch.equal(params[k].detach(), before[k])]
    check(not moved, f"{tag}: frozen parameters changed: {moved[:4]}")
    zero = [k for k, t in mask.items() if t and (
        params[k].grad is None or float(params[k].grad.abs().max()) == 0.0)]
    check(not zero, f"{tag}: zero gradient for trainable {zero[:4]}")
    same = [k for k, t in mask.items() if t
            and torch.equal(params[k].detach(), before[k])]
    check(not same, f"{tag}: trainable parameters unchanged: {same[:4]}")
    return sum(mask.values()), len(mask)


def i2i_step_flop(cfg, n_images: int) -> float:
    """Conv FLOPs of one i2i train step of VGG16 under its freeze mask: the
    forward of all 13 convs, and the backward of the trainable conv10-12
    (their weight gradients, and the input gradients of conv11 and conv12;
    conv10's input carries no gradient below the freeze)."""
    from gloc3d_tpu_torch.models.vgg import conv_flops

    s = cfg.bev.image_size
    top = 2 * (s // 16) ** 2 * 512 * 512 * 9  # one of conv10-12, per image
    return n_images * (conv_flops(1, s) + 5 * top)


def phase_i2i_train(torch, world, card):
    """[i2i-train]: PipelineConfig.i2i() (VGG16 + NetVLAD-FC, 64 x 512
    clusters, FC 32 768 → 512, bf16) at 768² on the training world's BEVs,
    the reference's freeze mask: one epoch (counted, checked), two timing
    epochs, one fp32 step card vs CPU at a 128² crop, and one step each of
    AlexNet, MobileNetV2 and ResNet18 with their masks."""
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.models.vgg import conv_flops

    dev = torch.device("cuda")
    # margin 10, as the JAX package's zoo test: every negative violates, so
    # every batch takes a step (seeded weights mine few violations at 0.1)
    base = PipelineConfig.i2i()
    cfg = base.replace(train=base.train.replace(
        cache_refresh_rate=N_TRAIN_Q, margin=10.0))
    ds = i2i_training_dataset(torch, cfg, world)
    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    n_img = b * (2 + n_neg)
    with tempfile.TemporaryDirectory() as workdir:
        tr, mask = i2i_trainer(torch, cfg, ds, workdir, dev)
        before = {k: p.detach().clone()
                  for k, p in tr.model.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        loss = tr.train_epoch(1)
        n_steps = tr.step
        check(n_steps >= 3, f"[i2i-train] only {n_steps} steps ran")
        check(math.isfinite(loss) and loss > 0, f"[i2i-train] loss {loss}")
        n_train, n_all = check_freeze(torch, "[i2i-train]", tr.model, mask,
                                      before)
        print(f"[i2i-train] VGG16 + NetVLAD-FC at "
              f"{cfg.bev.image_size}² bf16, epoch 1 over {N_TRAIN_Q} "
              f"queries ({n_img} images per step): {n_steps} steps, mean "
              f"loss {loss:.5f}; {n_train} of {n_all} parameters train "
              f"(conv10-12 and the pooling), every one with a nonzero "
              f"gradient and moved; the {n_all - n_train} frozen ones "
              f"bit-unchanged")
        steps, caches = [], []
        tr._train_batch = timed(torch, tr._train_batch, steps)
        tr.compute_cache = timed(torch, tr.compute_cache, caches)
        for epoch in (2, 3):
            tr.train_epoch(epoch)
        del tr._train_batch, tr.compute_cache
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms = float(np.median([s[0] for s in steps]))
        cache_ms = sum(s[0] for s in caches) / sum(s[1] for s in caches)
        flop = i2i_step_flop(cfg, n_img)
        mfu = flop / (step_ms * 1e-3) / 989e12
        print(f"[i2i-train] on {card}: {step_ms:.2f} ms per train step "
              f"(mining, gather, upload, forward, backward, SGD; CUDA "
              f"events around the whole step, median of {len(steps)} warm "
              f"steps of epochs 2-3); cache refresh {cache_ms:.3f} ms per "
              f"image ({sum(s[1] for s in caches)} images in batches of "
              f"8); peak device memory {peak:.2f} GiB; the step's conv "
              f"FLOPs {flop / 1e12:.3f} TFLOP (forward "
              f"{conv_flops(1, cfg.bev.image_size) / 1e9:.1f} GFLOP per "
              f"image and the backward of conv10-12) over its "
              f"time: {flop / (step_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{mfu:.3f} of 989 TFLOP/s dense bf16")
    out = {"step_ms": step_ms, "cache_ms_per_image": cache_ms,
           "peak_gib": peak, "step_tflop": flop / 1e12, "mfu": mfu,
           "steps": n_steps}
    out["reference"] = phase_i2i_train_reference(torch, cfg, ds)
    out["zoo"] = phase_i2i_train_zoo(torch, cfg, ds, card)
    return out


def phase_i2i_train_reference(torch, cfg, ds, crop: int = 128):
    """One fp32 VGG16 step, card against CPU, from the same weights and
    batch at a ``crop``² centre crop of the BEVs (TF32 off); the gradients
    within twice the CPU's mkldnn-on-vs-off floor, the loss within rtol
    1e-4."""
    from gloc3d_tpu_torch.data import dataset

    lo = (cfg.bev.image_size - crop) // 2
    small = dataset.TripletDataset(
        db_inputs=np.ascontiguousarray(ds.db_inputs[:, lo:lo + crop,
                                                     lo:lo + crop]),
        q_inputs=np.ascontiguousarray(ds.q_inputs[:, lo:lo + crop,
                                                  lo:lo + crop]),
        utm_db=ds.utm_db, utm_q=ds.utm_q)
    c = cfg.replace(model=cfg.model.replace(compute_dtype="float32"))
    b, n_neg = c.train.batch_size, c.train.n_neg
    dist = np.linalg.norm(small.utm_q[:b, None] - small.utm_db[None], axis=-1)
    pos = dist.argmin(1)
    neg = np.concatenate([np.flatnonzero(d > 20.0)[:n_neg] for d in dist])
    batch = (small.q_inputs[:b], None, small.db_inputs[pos], None,
             small.db_inputs[neg], None, np.ones((b, n_neg), np.float32),
             np.ones(b, np.float32))
    with tempfile.TemporaryDirectory() as workdir:
        # NetVLAD from the queries' crops: no centroid is a batch feature
        tr, _ = i2i_trainer(torch, c, small, workdir, "cuda",
                            vlad_from=small.q_inputs[b:])
        init = {k: v.cpu() for k, v in tr.model.state_dict().items()}

    def step(device, mkldnn=True):
        from gloc3d_tpu_torch.models.descriptor import build_model
        from gloc3d_tpu_torch.models.encoders import train_mask
        from gloc3d_tpu_torch.train import Trainer

        model = build_model(c.model, c.voxel)
        model.load_state_dict(init)
        torch.backends.mkldnn.enabled = mkldnn
        try:
            with tempfile.TemporaryDirectory() as workdir:
                tr = Trainer(c, model, small, workdir, device=device,
                             trainable_mask=train_mask(model, "vgg16"))
                loss = float(tr.train_step(*batch))
        finally:
            torch.backends.mkldnn.enabled = True
        return loss, {k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()
                      if p.grad is not None}

    (l_g, g_g), (l_c, g_c) = step("cuda"), step("cpu")
    _, g_o = step("cpu", mkldnn=False)
    print(f"[i2i-train-reference] fp32 VGG16 step at {crop}² crops, card vs "
          f"CPU: loss {l_g:.7f} vs {l_c:.7f} (rel "
          f"{abs(l_g - l_c) / abs(l_c):.2e}, bound 1e-4); {len(g_c)} "
          f"trainable tensors")
    check(abs(l_g - l_c) <= 1e-4 * abs(l_c), f"[i2i-train-reference] card "
          f"loss {l_g} vs CPU {l_c}")
    floor = grad_floor(g_c, g_o)
    worst = grad_floor_check("i2i-train-reference", g_g, g_c, floor,
                             "mkldnn convolutions off vs on")
    return {"loss_rel": abs(l_g - l_c) / abs(l_c), "grad_worst": worst,
            "cpu_floor": floor}


def phase_i2i_train_zoo(torch, cfg, ds, card):
    """One bf16 step each of AlexNet, MobileNetV2 and ResNet18 at 768² under
    their freeze masks, on the step batch of the VGG16 phase."""
    from gloc3d_tpu_torch import PipelineConfig

    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    dist = np.linalg.norm(ds.utm_q[:b, None] - ds.utm_db[None], axis=-1)
    pos = dist.argmin(1)
    neg = np.concatenate([np.flatnonzero(d > 20.0)[:n_neg] for d in dist])
    batch = (ds.q_inputs[:b], None, ds.db_inputs[pos], None,
             ds.db_inputs[neg], None, np.ones((b, n_neg), np.float32),
             np.ones(b, np.float32))
    out = {}
    for enc in ("alexnet", "mobilenet", "resnet18"):
        zc = PipelineConfig.i2i(enc)
        zc = zc.replace(train=cfg.train)
        with tempfile.TemporaryDirectory() as workdir:
            tr, mask = i2i_trainer(torch, zc, ds, workdir, "cuda")
            before = {k: p.detach().clone()
                      for k, p in tr.model.named_parameters()}
            loss = float(tr.train_step(*batch))
            check(math.isfinite(loss) and loss > 0,
                  f"[i2i-train] {enc}: loss {loss}")
            n_train, n_all = check_freeze(torch, f"[i2i-train] {enc}",
                                          tr.model, mask, before)
            ms = cuda_ms(torch, lambda: tr.train_step(*batch), 3)
        out[enc] = {"loss": loss, "step_ms": ms}
        print(f"[i2i-train] {enc} at {zc.bev.image_size}² bf16, one step "
              f"of {len(batch[0]) * (2 + n_neg)} images under its freeze "
              f"mask: loss {loss:.5f}; {n_train} of {n_all} parameters "
              f"train, every one with a nonzero gradient and moved, the "
              f"frozen ones bit-unchanged; {out[enc]['step_ms']:.2f} ms per "
              f"step on {card} (CUDA events, mean of 3 after 3 warm-up "
              f"steps)")
    return out


def pose_pairs(world, n: int, b: int = 4):
    """b scan pairs of the walled world: a query scan and a reference scan
    1-3 m and up to 0.3 rad away, with gt the angle-axis | translation of
    T_p←q (q's frame into p's)."""
    rng = np.random.RandomState(31)
    qs, ps, gt = [], [], np.zeros((b, 6), np.float32)
    for i in range(b):
        q = (rng.uniform(-30, 30), rng.uniform(-20, 20),
             rng.uniform(-np.pi, np.pi))
        p = (q[0] + rng.uniform(-3, 3), q[1] + rng.uniform(-3, 3),
             q[2] + rng.uniform(-0.3, 0.3))
        qs.append(scan_at(world, q, n, seed=700 + i))
        ps.append(scan_at(world, p, n, seed=800 + i))
        c, s = np.cos(-p[2]), np.sin(-p[2])
        dx, dy = q[0] - p[0], q[1] - p[1]
        gt[i] = (0.0, 0.0, q[2] - p[2], c * dx - s * dy, s * dx + c * dy,
                 0.0)
    stack = [np.stack([s[j] for s in scans]) for scans in (qs, ps)
             for j in (0, 1)]
    return tuple(stack), gt


def phase_pose_train(torch, world, card, steps: int = 25):
    """[pose-train]: make_pose_model(PipelineConfig.s2s()) at the full
    140 x 80 grid (bf16 convs), 4 walled-world pairs at the 122 480 pad,
    Adam 1e-3, 25 steps on the fixed batch: JAX's criterion, K2 launch and
    backward counts, every K2 launch of one step against its plain
    version, one fp32 step card vs CPU, predict_pose."""
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.train import pose

    cfg = PipelineConfig.s2s()
    batch, gt = pose_pairs(world, cfg.voxel.max_points)
    dev_batch = [torch.from_numpy(a).cuda() for a in batch]
    state = pose.init_pose_state(pose.make_pose_model(cfg), lr=1e-3,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(bs.pillar_bin_sums)
    bs.pillar_bin_sums_grad.backward_calls = 0
    losses, ms = [], []
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss = pose.pose_train_step(state, dev_batch, gt)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    k2 = launches_of(bs.pillar_bin_sums)
    k2_bwd = bs.pillar_bin_sums_grad.backward_calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median(ms[3:]))
    print(f"[pose-train] PosePairModel at the 140 x 80 grid, "
          f"{cfg.model.compute_dtype} convs, 4 pairs x "
          f"{cfg.voxel.max_points} points, Adam 1e-3, {steps} "
          f"steps on {card}: losses {losses[0]:.4f} {losses[1]:.4f} "
          f"{losses[2]:.4f} ... min {min(losses):.4f} (criterion: below 0.7 "
          f"x {max(losses[:3]):.4f}); {step_ms:.2f} ms per step (CUDA "
          f"events, median of steps 4-{steps}); peak device memory "
          f"{peak:.2f} GiB; K2 launches {k2}, backward calls {k2_bwd}")
    check(all(math.isfinite(v) for v in losses), f"[pose-train] {losses}")
    check(min(losses) < 0.7 * max(losses[:3]),
          f"[pose-train] the loss did not fall: {losses}")
    check((k2, k2_bwd) == (4 * steps, 2 * steps), f"[pose-train] (K2, K2 "
          f"backward) = {(k2, k2_bwd)}, expected {(4 * steps, 2 * steps)}")
    pred = pose.predict_pose(state, dev_batch)
    check(tuple(pred.shape) == (4, 6) and bool(torch.isfinite(pred).all()),
          f"[pose-train] predict_pose {tuple(pred.shape)}")

    launches = record_launches(
        lambda: pose.pose_train_step(state, dev_batch, gt))
    check(len(launches["K2"]) == 4 and not launches["K1"],
          f"[pose-train] recorded {len(launches['K2'])} K2 launches")
    parts = []
    for args in launches["K2"]:
        rel = check_k2(torch, "[pose-train]", *args)[0]
        check(rel < 1e-5, f"[pose-train] K2 {tuple(args[0].shape)} "
              f"disagrees with its plain version: {rel:.3e}")
        parts.append(f"{tuple(args[0].shape)} {rel:.2e}")
    print("[pose-train] every K2 launch of one step against its plain "
          "version, error relative to per-pillar L1 mass (bound 1e-5; "
          "counts exactly equal): " + ", ".join(parts))
    ref = phase_pose_train_reference(torch, cfg, batch, gt)
    return {"step_ms": step_ms, "peak_gib": peak, "losses": losses,
            "k2_launches": k2, "k2_backward": k2_bwd, "reference": ref}


def phase_pose_train_reference(torch, cfg, batch, gt, n_pts: int = 16384):
    """One fp32 pose step, card against CPU, from the same weights at a
    16 384-point pad: loss within rtol 1e-4, gradients within twice the
    CPU's own floor. The card sums in other orders than the CPU in every
    convolution and reduction (K2 adds in a fixed order and rounds once,
    but the features it bins differ in their last bits), so the floor is
    the largest of four CPU reruns that
    change only orders of summation: mkldnn convolutions off;
    every cloud's rows (and mask) permuted, which reorders the pillar sums
    and the PointNet BatchNorm's statistics; and the rows permuted on one
    thread without mkldnn, and on three threads, which reorders every
    reduction. (On an H100 the card read 9.2e-3-1.0e-2 from the CPU with
    K2 v2's float atomics and 9.1e-3-9.8e-3 with v3's integer sums, where
    mkldnn off or permuted rows alone moved the CPU by 2.1e-3-6.2e-3 and
    the thread count by 1.1e-2-1.9e-2: K2 never set the floor.)

    A control shows the bound still fails a wrong step: the same step on
    the card with the convolutions and matmuls in bf16 must lie beyond
    it."""
    from gloc3d_tpu_torch.train import pose

    small = [np.ascontiguousarray(a[:, :n_pts]) for a in batch]

    def permuted(seed):
        perm = np.random.RandomState(seed).permutation(n_pts)
        return [np.ascontiguousarray(a[:, perm]) for a in small]

    def model_for(dtype):
        return pose.make_pose_model(cfg.replace(
            model=cfg.model.replace(compute_dtype=dtype)))

    init = pose.init_pose_params(model_for("float32"),
                                 torch.Generator().manual_seed(1)
                                 ).state_dict()

    def step(device, mkldnn=True, clouds=small, dtype="float32"):
        model = model_for(dtype)
        model.load_state_dict(init)
        torch.backends.mkldnn.enabled = mkldnn
        try:
            st = pose.init_pose_state(model, init=False, device=device)
            loss = float(pose.pose_train_step(
                st, [torch.from_numpy(a) for a in clouds], gt))
        finally:
            torch.backends.mkldnn.enabled = True
        return loss, {k: p.grad.detach().cpu()
                      for k, p in st.model.named_parameters()}

    (l_g, g_g), (l_c, g_c) = step("cuda"), step("cpu")
    reruns = [step("cpu", mkldnn=False)[1],
              step("cpu", clouds=permuted(5))[1]]
    threads = torch.get_num_threads()
    try:
        for n_threads, mkldnn, seed in ((1, False, 6), (3, True, 7)):
            torch.set_num_threads(n_threads)
            reruns.append(step("cpu", mkldnn, permuted(seed))[1])
    finally:
        torch.set_num_threads(threads)
    print(f"[pose-train-reference] fp32 pose step at {n_pts} points, card "
          f"vs CPU: loss {l_g:.7f} vs {l_c:.7f} (rel "
          f"{abs(l_g - l_c) / abs(l_c):.2e}, bound 1e-4)")
    check(abs(l_g - l_c) <= 1e-4 * abs(l_c), f"[pose-train-reference] card "
          f"loss {l_g} vs CPU {l_c}")
    floor = grad_floor(g_c, *reruns)
    worst = grad_floor_check(
        "pose-train-reference", g_g, g_c, floor, "mkldnn convolutions off, "
        "the rows permuted, or permuted on 1 or 3 threads")
    l_b, g_b = step("cuda", dtype="bfloat16")
    control = grad_rel(g_b, g_c)
    n_over = sum(v > 2 * floor for v in control.values())
    print(f"[pose-train-reference] control, the card step in bf16: loss "
          f"{l_b:.7f} (rel {abs(l_b - l_c) / abs(l_c):.2e}); gradient "
          f"|diff| / |grad| worst {max(control.values()):.2e}, median "
          f"{np.median(list(control.values())):.2e}, {n_over} of "
          f"{len(control)} tensors beyond the bound {2 * floor:.2e}")
    check(max(control.values()) > 2 * floor, "[pose-train-reference] the "
          f"bound {2 * floor:.3e} does not fail the bf16 step")
    return {"loss_rel": abs(l_g - l_c) / abs(l_c), "grad_worst": worst,
            "cpu_floor": floor, "bf16_worst": max(control.values()),
            "bf16_median": float(np.median(list(control.values()))),
            "bf16_over": n_over}


def capture_pillars(model):
    """Wrap ``model.bev_heads`` so each call keeps its pillar-mean input."""
    seen = []
    real = model.bev_heads

    def bev_heads(pillar, mode=None):
        seen.append(pillar.detach())
        return real(pillar, mode)

    model.bev_heads = bev_heads
    return seen


def phase_packed(torch, world, card):
    """[packed]: one full-pad scan through the port's PointPillar (K2),
    PointPillarPacked (pack_points + K2) and PointPillarSorted (the host
    pass + K1), one fp32 state dict: the pillar means within 1e-5 of the
    largest of PointPillar's (K2 v3's sums depended on no row order, so
    the packed path came out bit-equal on an H100; v4 adds a pillar's rows
    in their row order; the sorted path's
    centre-relative statistics change per-point features in their last
    bits), the outputs
    within 1e-4 of their largest element; forward times; K1 / K2
    launches."""
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.models.descriptor import init_params
    from gloc3d_tpu_torch.models.packed import (
        PointPillarPacked, PointPillarSorted, pack_points)
    from gloc3d_tpu_torch.models.pointpillar import PointPillar

    v = PipelineConfig.s2s().voxel
    pts, mask = scan_at(world, (5.0, -3.0, 0.4), v.max_points, seed=41)
    bounds = (v.xbound, v.ybound, v.zbound)
    sd = init_params(PointPillar(*bounds, torch.float32), seed=2
                     ).state_dict()
    models = {}
    for cls in (PointPillar, PointPillarPacked, PointPillarSorted):
        m = cls(*bounds, torch.float32)
        m.load_state_dict(sd)  # one state dict for all three
        models[cls.__name__] = m.cuda().eval()
    p_d = torch.from_numpy(pts[None]).cuda()
    m_d = torch.from_numpy(mask[None]).cuda()
    host = native.compute_voxel_stats_host_sorted(
        pts[None], mask[None].sum(1).astype(np.int64), *bounds, crop=False)
    sorted_in = [torch.from_numpy(host[i]).cuda() for i in (0, 1, 2, 5)]
    calls = {
        "PointPillar": lambda: models["PointPillar"](p_d, m_d),
        "PointPillarPacked": lambda: models["PointPillarPacked"](
            pack_points(p_d, m_d, *bounds)),
        "PointPillarSorted": lambda: models["PointPillarSorted"](
            *sorted_in),
    }
    outs, pillars, launches = {}, {}, {}
    with torch.no_grad():
        for name, fn in calls.items():
            seen = capture_pillars(models[name])
            reset_launches(ss.segment_sum_sorted)
            reset_launches(bs.pillar_bin_sums)
            outs[name] = fn()
            torch.cuda.synchronize()
            launches[name] = (launches_of(ss.segment_sum_sorted),
                              launches_of(bs.pillar_bin_sums))
            pillars[name] = seen[0]
            del models[name].bev_heads
        ref_p, ref_o = pillars["PointPillar"], outs["PointPillar"]
        res = {}
        for name in ("PointPillarPacked", "PointPillarSorted"):
            prel = float((pillars[name] - ref_p).abs().max()
                         / ref_p.abs().max())
            orel = float((outs[name] - ref_o).abs().max()
                         / ref_o.abs().max())
            ms = cuda_ms(torch, calls[name], 10)
            res[name] = {"pillar_rel": prel, "out_rel": orel, "ms": ms,
                         "K1": launches[name][0], "K2": launches[name][1]}
            print(f"[packed] {name} vs PointPillar on one {v.max_points}-"
                  f"point scan at fp32 on {card}: pillar means within "
                  f"{prel:.2e} of the largest (bound 1e-5), "
                  f"outputs within {orel:.2e} of their largest element "
                  f"(bound 1e-4); forward {ms:.3f} ms (CUDA events, mean "
                  f"of 10); launches K1 {launches[name][0]}, K2 "
                  f"{launches[name][1]}")
            check(prel < 1e-5 and orel < 1e-4, f"[packed] {name} differs "
                  f"from PointPillar: pillars {prel:.3e}, outputs "
                  f"{orel:.3e}")
        res["PointPillar"] = {"ms": cuda_ms(torch, calls["PointPillar"], 10),
                              "K2": launches["PointPillar"][1]}
    print(f"[packed] PointPillar forward {res['PointPillar']['ms']:.3f} ms "
          f"on {card} (K2 launches {launches['PointPillar'][1]})")
    check(launches["PointPillarPacked"] == (0, 2)
          and launches["PointPillarSorted"] == (2, 0),
          f"[packed] launches (K1, K2): {launches}")
    return res


def kernel_time_cases(torch, cfg, ds, k1_main, k2_main):
    """The inputs phase_kernel_times takes: each kernel at the main path's
    shapes (K1 on a real scan's sorted rows; K2's two binnings of the
    aligned scan) and at the train step's (24, 122480, ·)."""
    t = train_kernel_inputs(torch, cfg, ds)
    n, b = cfg.voxel.max_points, t["x"].shape[0]
    v, ids = t["vox"]["num_voxels"], t["vox"]["voxel_indices"]
    k1 = {"main path": k1_main, "train step": (t["x"], t["starts"])}
    k2 = {"main path, statistics": k2_main["statistics"],
          "main path, features": k2_main["features"],
          "train step, statistics": (t["payload"], ids, v),
          "train step, features": (t["x"], ids, v)}
    check(tuple(k2_main["features"][0].shape) == (1, n, 64)
          and tuple(t["x"].shape) == (b, n, 64), "kernel-time shapes")
    return k1, k2


def kernel_entry(key, times, label):
    """The kernel-only fields of a kernel's JSON entry: its main-path case
    at the top level, every case under ``cases``."""
    main = times[key][label]
    return {"kernel_only_ms": main["kernel_only_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "wrapper_ms": main["wrapper_ms"],
            "cases": times[key]}


def main(argv) -> int:
    import torch

    kernels_only = "--kernels" in argv
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0
    name, card = phase_device(torch)
    sys.path.insert(0, REPO)
    from gloc3d_tpu_torch import PipelineConfig

    if "--submap" in argv:
        print(json.dumps({"submap": phase_submap(torch, card, make_world())}))
        return 0
    alone = {"--i2i-train": ("i2i_train", phase_i2i_train),
             "--pose-train": ("pose_train", phase_pose_train),
             "--packed": ("packed", phase_packed)}
    if any(flag in argv for flag in alone):
        phase_build()
        world = make_world()
        for flag, (key, phase) in alone.items():
            if flag in argv:
                print(json.dumps({"card": card,
                                  key: phase(torch, world, card)}))
        return 0

    cfg = PipelineConfig.s2s()
    cfg = cfg.replace(model=cfg.model.replace(fold_bn=True))
    world = make_world()
    if "--eval" in argv:
        phase_build()
        print(json.dumps({"card": card,
                          "eval": phase_eval(torch, cfg, world, card)[0]}))
        return 0
    if "--cli" in argv:
        phase_build()
        print(json.dumps({"card": card,
                          "cli": phase_cli(torch, cfg, world, card)[0]}))
        return 0
    if "--shard" in argv:
        phase_build()
        lq_set = located_world_scans(world, cfg.voxel.max_points)
        centroids = vlad_centroids(torch, cfg, lq_set[0][1][:4])
        loc, kf, qs, _ = phase_located_query(torch, cfg, lq_set, centroids)
        print(json.dumps({"card": card, "shard": phase_shard(
            torch, card, cfg, loc, kf, qs, seed)}))
        return 0
    if "--spatial" in argv:
        phase_build()
        lq_set = located_world_scans(world, cfg.voxel.max_points)
        print(json.dumps({"card": card, "spatial": phase_spatial(
            torch, card, lq_set)}))
        return 0
    if "--device-sort" in argv:
        phase_build()
        kf_set, q_set = aligned_world_scans(world, cfg.voxel.max_points)
        centroids = vlad_centroids(torch, cfg, kf_set[2][:4])
        _, dsort = phase_device_sort(torch, cfg, kf_set, q_set, centroids,
                                     card)
        print(json.dumps({"card": card, "device_sort": dsort}))
        return 0
    if "--surface" in argv:
        phase_build()
        kf_set, q_set = aligned_world_scans(world, cfg.voxel.max_points)
        centroids = vlad_centroids(torch, cfg, kf_set[2][:4])
        model = build_serving_model(torch, cfg, "bfloat16", centroids)
        _, a_results, _, _ = phase_aligned_query(torch, cfg, model, kf_set,
                                                 q_set)
        print(json.dumps({"card": card, "surface": phase_surface(
            torch, a_results, q_set[2], card)}))
        return 0
    if "--batched" in argv:
        kf_set, q_set = aligned_world_scans(world, cfg.voxel.max_points)
        phase_build()
        centroids = vlad_centroids(torch, cfg, kf_set[2][:4])
        lq_set = located_world_scans(world, cfg.voxel.max_points)
        loc, _, _, _ = phase_located_query(torch, cfg, lq_set, centroids)
        model = build_serving_model(torch, cfg, "bfloat16", centroids)
        a_loc, _, _, _ = phase_aligned_query(torch, cfg, model, kf_set,
                                             q_set)
        print(json.dumps({"card": card, "batched": phase_batched(
            torch, cfg, centroids, lq_set, kf_set, q_set, loc, a_loc,
            card)}))
        return 0
    if "--knn" in argv:
        phase_build()
        print(json.dumps({"card": card, "knn": phase_knn(torch, cfg, world,
                                                         card)}))
        return 0
    if "--fused-graph" in argv:
        kf_set, q_set = aligned_world_scans(world, cfg.voxel.max_points)
        phase_build()
        centroids = vlad_centroids(torch, cfg, kf_set[2][:4])
        lq_set = located_world_scans(world, cfg.voxel.max_points)
        fused_graph = phase_fused_graph(torch, cfg, world, centroids, lq_set,
                                        kf_set, q_set, card)
        phase_fused_cell(torch, cfg, centroids, card)
        print(json.dumps({"card": card, "fused_graph": fused_graph}))
        return 0
    if "--dp" in argv:
        phase_build()
        lq_set = located_world_scans(world, cfg.voxel.max_points)
        centroids = vlad_centroids(torch, cfg, lq_set[0][1][:4])
        print(json.dumps({"card": card, "dp": phase_dp(
            torch, card, cfg, world, centroids)}))
        return 0
    kf_set, q_set = aligned_world_scans(world, cfg.voxel.max_points)
    phase_build()
    centroids = vlad_centroids(torch, cfg, kf_set[2][:4])
    k1_err, k1_ms, k1_plain_ms, k1_main = phase_k1(torch, cfg, world, card)
    k1_pillar0_same = check_k1_pillar0_determinism(torch, *k1_main)
    k2_err, k2_ms, k2_plain_ms, k2_main = phase_k2(torch, cfg, world, card,
                                                   centroids)
    k2_bit_equal = check_k2_determinism(torch, k2_main)
    k2_earlier = None
    if "--k2-compare" in argv:
        src = argv[argv.index("--k2-compare") + 1]
        k2_earlier = (src, k2_earlier_launch(torch, src), K2_V3_OPS)
    if kernels_only:
        ds = training_dataset(world, cfg.voxel.max_points)
        times = phase_kernel_times(torch, card, *kernel_time_cases(
            torch, cfg, ds, k1_main, k2_main), k2_earlier=k2_earlier)
        times["knn_normals"] = phase_knn(torch, cfg, world, card)
        print(json.dumps({"card": card, "kernel_times": times}))
        return 0
    lq_set = located_world_scans(world, cfg.voxel.max_points)
    loc, kf, qs, k1_launches = phase_located_query(torch, cfg, lq_set,
                                                   centroids)
    phase_reference(torch, cfg, kf, qs, centroids)

    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    a_loc, a_results, k2_launches, knn_aligned = phase_aligned_query(
        torch, cfg, model, kf_set, q_set)
    print(json.dumps({"card": card, "surface": phase_surface(
        torch, a_results, q_set[2], card)}))
    phase_aligned_hoststats(torch, cfg, kf_set, q_set, centroids)
    phase_aligned_reference(torch, cfg, kf_set, q_set, centroids)
    k1_dsort, dsort = phase_device_sort(torch, cfg, kf_set, q_set,
                                        centroids, card)
    print(json.dumps({"card": card, "device_sort": dsort}))

    batched = phase_batched(torch, cfg, centroids, lq_set, kf_set, q_set,
                            loc, a_loc, card)
    print(json.dumps({"card": card, "batched": batched}))
    k1_fused, k2_fused = phase_fused_query(torch, cfg, lq_set, kf_set, q_set,
                                           centroids)
    flat_ms = phase_fused_cell(torch, cfg, centroids, card)
    phase_fused_reference(torch, cfg, lq_set, centroids)
    fused_graph = phase_fused_graph(torch, cfg, world, centroids, lq_set,
                                    kf_set, q_set, card)
    print(json.dumps({"card": card, "fused_graph": fused_graph}))
    fg_k1, fg_k2, fg_knn = (sum(rec[bank]["launches"][i]
                                for bank in FUSED_BANKS
                                for rec in fused_graph.values())
                            for i in (0, 1, 2))
    map_scale = phase_map_scale(torch, card, seed)
    city = phase_city(torch, cfg, centroids, card, flat_ms)
    shard = phase_shard(torch, card, cfg, loc, kf, qs, seed)
    print(json.dumps({"card": card, "map_scale": map_scale, "city": city,
                      "shard": shard}))
    dp = phase_dp(torch, card, cfg, world, centroids)
    print(json.dumps({"card": card, "dp": dp}))
    print(json.dumps({"card": card, "spatial": phase_spatial(
        torch, card, lq_set)}))
    dp_k = dp["launches"]

    phase_timing(torch, cfg, loc, kf, qs, card)
    phase_aligned_timing(torch, cfg, a_loc, q_set[2], card)
    i2i = run_i2i(torch, kf_set, q_set, lq_set, card)
    print(json.dumps({"card": card, "i2i": i2i}))
    refine, k1_refine, k2_refine = run_refine(
        torch, cfg, lq_set, kf_set, q_set, centroids, model, a_results, card)
    print(json.dumps({"card": card, "refine": refine}))
    print(json.dumps({"submap": phase_submap(torch, card, world)}))
    eval_rec, k1_eval, k2_eval = phase_eval(torch, cfg, world, card)
    print(json.dumps({"card": card, "eval": eval_rec}))
    cli_rec, k1_cli, k2_cli, k2_export = phase_cli(torch, cfg, world, card)
    print(json.dumps({"card": card, "cli": cli_rec}))

    ds = training_dataset(world, cfg.voxel.max_points)
    train_counts = phase_training(torch, cfg, ds, card)
    bwd = phase_train_kernels(torch, cfg, ds, card)
    phase_train_reference(torch, cfg, ds)
    i2i_train = phase_i2i_train(torch, world, card)
    pose_train = phase_pose_train(torch, world, card)
    packed = phase_packed(torch, world, card)
    print(json.dumps({"card": card, "i2i_train": i2i_train,
                      "pose_train": pose_train, "packed": packed}))
    times = phase_kernel_times(torch, card, *kernel_time_cases(
        torch, cfg, ds, k1_main, k2_main), k2_earlier=k2_earlier)
    knn = phase_knn(torch, cfg, world, card)
    print(json.dumps({"card": card, "knn": knn}))
    k1_paths = {"located query": k1_launches,
                "fused query, host-stats": k1_fused,
                "training, host-stats": train_counts["host-stats"][0],
                "refine, host-stats": k1_refine,
                "eval, host-stats": k1_eval,
                "cli, host-stats": k1_cli,
                "sorted": packed["PointPillarSorted"]["K1"],
                "dp step + extraction, host-stats, world 1":
                    dp_k["dp step world 1, host-stats"][0]
                    + dp_k["dp extraction world 1, host-stats"][0],
                "sharded store, host-stats, world 1":
                    shard["store"]["k1_launches"],
                "sharded store, host-stats, world 2 rank 0": int(
                    shard["store world 2"]["store_k1_launches"]),
                "device sort, aligned all-device": k1_dsort,
                "fused graph, every variant and bank": fg_k1}
    k2_paths = {"aligned query": k2_launches,
                "fused query, aligned all-device": k2_fused,
                "training, all-device": train_counts["all-device"][1],
                "refine, aligned all-device": k2_refine,
                "eval, aligned all-device": k2_eval,
                "cli, aligned": k2_cli,
                "exported program": k2_export,
                "pose training, all-device": pose_train["k2_launches"],
                "packed": packed["PointPillarPacked"]["K2"],
                "dp step + extraction, all-device, world 1":
                    dp_k["dp step world 1, all-device"][1]
                    + dp_k["dp extraction world 1, all-device"][1],
                "fused graph, every variant and bank": fg_k2}
    knn_paths = {"aligned map build and queries": knn_aligned,
                 "locate_batch, aligned": batched["aligned"]["knn_batch"],
                 "fused graph, every variant and bank": fg_knn}
    print(json.dumps({"kernels": [
        {"name": "segment_sum_sorted", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": sum(k1_paths.values()),
         "launches_by_path": k1_paths,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "pillar0_bit_equal": k1_pillar0_same,
         **kernel_entry("K1", times, "main path"),
         "backward_max_abs_err": bwd["K1"][0], "backward_ms": bwd["K1"][1],
         "plain_backward_ms": bwd["K1"][2]},
        {"name": "pillar_bin_sums", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": sum(k2_paths.values()),
         "launches_by_path": k2_paths,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bit_equal": k2_bit_equal,
         **kernel_entry("K2", times, "main path, features"),
         "backward_max_abs_err": bwd["K2"][0], "backward_ms": bwd["K2"][1],
         "plain_backward_ms": bwd["K2"][2]},
        {"name": "knn_normals", "route": "cuda", "source": KNN_SOURCE,
         "replaces": KNN_REPLACES, "launches": sum(knn_paths.values()),
         "launches_by_path": knn_paths,
         "max_abs_err": max(r["max_abs_err"] for r in knn.values()),
         "bit_equal": all(r["bit_equal"] for r in knn.values()),
         "ms": knn["B=1"]["wrapper_ms"],
         "kernel_only_ms": knn["B=1"]["kernel_only_ms"],
         "bound_ms": knn["B=1"]["bound_ms"],
         "bound_by": knn["B=1"]["bound_by"],
         "wrapper_ms": knn["B=1"]["wrapper_ms"],
         "plain_ms": knn["B=1"]["plain_warm_ms"],
         "replaced_chain_ms": knn["B=1"]["chain_ms"], "cases": knn}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
