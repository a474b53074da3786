#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage-1 and stage-2 inference and training on
one NVIDIA GPU, on the two-stage and the fused point-feature paths.

Usage, from the root of the repository:  python3 chip_smoke.py

Phases, any failure exits non-zero:
 1. device: a CUDA card must be present; prints its name and power limit and
    turns TF32 off;
 2. build: compiles the hand-written kernels from dcl_net_tpu_torch/csrc/;
 3. kernels: holds each kernel (K1 voxelize, K2 compaction, K3 3-NN
    interpolation, K4 its backward, K5 the compaction's backward, K6 the
    fused compaction -> interpolation, K7 its backward) to its plain
    PyTorch version on the card, at the shapes the main paths give it
    (batch 32, 64^3 grid, 1024 points): K1 bit-equal in modes 3 and 4, on
    the main-path batch and on an adversarial one (one full cell, tile
    edges, the last cell, masked and out-of-range points); K5 bit-equal at
    every level, below the occupancy and with an empty sample, after a
    check of its precondition on K2's output; K6 also bit-equal to K2 ->
    voxel_centers -> K3, at every level and on an adversarial set in coords
    form (tie lattices, 0-3 valid slots, cap % 4 != 0, occupancy above cap,
    a two-tile sample of 3000 slots); K4 and K7 at every level bit-equal to their plain
    versions run on CPU copies of the inputs and from launch to launch, on
    the main-path inputs and on an adversarial set (one slot taking all
    3 * 1024 contributions of a sample), within a tolerance of the plain
    versions run on the card (whose index_add_ adds in a run-dependent
    order), their inverse index bit-equal to its plain version. K3 as the
    main path calls it (n_valid = K2's occupancy) torch.equal to K3 on all
    cap rows, at every level and on an adversarial set (tie lattices, 0-3
    valid centers, an empty sample, N = 1000, V % 4 != 0, a non-prefix
    mask: idx equal to the plain version's, out and w within INTERP_ATOL).
    Times the kernel as called and on the device alone (CUDA-graph replay;
    K2, K3 and K6 also per level, K3 also on all cap rows), the plain version,
    and a PyTorch library call computing the same function where one
    exists, as called and on the device (K1: index_add_ then the divide;
    also index_add_ alone, which is mode 3's function); K2, K3 and K6 at the
    configs' eval batch of 512 (the batch-32 levels repeated 16 times,
    each output equal to the batch-32 output repeated); then one encode's
    point-feature stage on both paths;
 4. eval path: the full-width DCLNet of configs/config_YCBV_bs32.yaml
    (random weights from a seed) through Evaluator over the synthetic
    dataset's 16-class template bank and several batches of 32; checks
    finite outputs, the kernels' launch counts per encode, and one batch
    against the same path with the plain versions on the card; then the
    same weights and batches on the fused path (interp_mode="pallas_fused":
    launches 1/4/4 of K1/K2/K6 per encode, no K3), its poses against the
    two-stage path's and the plain versions';
 5. training path: Solver with that config's model, optimizer, schedule and
    batch 32 on the synthetic dataset, a warm-up step and a few timed
    steps; checks finite losses and gradient norms, changed parameters and
    BN statistics, and the launch counts per step (K1 2, K2-K5 8 each);
 6. one train step's losses and gradients from the same state through the
    kernels and through their plain versions;
 7. training on the fused path through Solver (a warm-up and
    FUSED_TRAIN_STEPS timed steps, launches K1 2, K2 8, K6 8, K7 8 per
    step, no K3, K4 or K5), and one step against the two-stage path and the
    plain versions; both training comparisons print how far a step's
    gradient through the kernels moves between two passes;
 8. stage 2 at full width on the fused stage 1: Stage2Evaluator with
    ITERATIONS refinement steps over the eval batches (against the plain
    versions on one batch), then the refiner's training through
    Solver(step_builder=make_stage2_train_step) with
    configs/config_YCBV_bs40.yaml's optimizer at batch 40 // ITERATIONS, a
    warm-up and STAGE2_TRAIN_STEPS timed steps (stage 1 frozen: no
    backward kernel runs, its weights and BN statistics stay);
 9. the YCB-V eval CLIs from PNG files on disk: writes a 21-class,
    26-frame tree without PIL (scripts/ycbv_tree.py: 546 instances, 26 of
    them lost detections), builds the PNG host library, and runs
    tools/test_ycbv_stage1.main at the config's eval batch of 512 (or the
    largest power of two that fits, the out-of-memory point printed) with a
    checkpoint of the seeded model: timed with the config's loader threads
    (instances/s end to end and of the evaluate loop, the loader's and
    reader's share, peak device memory), then two-stage and fused on the
    same inputs (poses per instance within POSE_ATOL), then at batch 32;
    then tools/test_ycbv_stage2.main with a refiner checkpoint. Each run's
    scored and lost rows, results file and launch counts (one template-bank
    encode, then one observed encode a batch) are checked;
10. the LineMOD family and reference weights: writes a LineMOD tree (13
    objects, spheres 10-28 cm across, 520 eval rows of which 65 have an
    empty SegNet label; 104 train rows) and an Occlusion-LineMOD tree (8
    objects, 520 rows, 40 with an empty mask) without PIL
    (scripts/lm_tree.py), and runs tools/test_lm.main and
    tools/test_lmo.main with configs/config_LM.yaml (5 mm voxels) at its
    eval batch of 512 and a checkpoint of a seeded model: timed with the
    config's loader threads, then two-stage and fused with one loader
    thread (poses per instance within POSE_ATOL), K2's rows per level and
    n_overflow printed, and test_lm again with model.capacities above
    those rows (n_overflow 0); then test_lm from a reference .pth of seeded
    weights and from the port checkpoint converted from it (poses
    torch.equal); then tools/train_stage1.main on the LineMOD tree, one
    epoch of 3 steps at batch 32. Each run's scored, lost and counted rows,
    results file and launch counts are checked, and the training's losses,
    changed parameters and launches (K1 2, K2-K5 8 a step);
11. prints the per-kernel JSON line, then the result line
    {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 32
N_BATCHES = 6
N_CLASSES = 16
MODEL_POINTS = 1024
TRAIN_STEPS = 5  # timed training steps after one warm-up step
FUSED_TRAIN_STEPS = 3
STAGE2_TRAIN_STEPS = 5
ITERATIONS = 2  # refinement steps of stage 2
REPEAT = 16  # K2, K3, K6 are also timed at batch BATCH * REPEAT = 512, the configs' eval batch
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Tolerances of kernel vs plain version, with their reasons. K1 is held
# bit-equal: it sums each voxel's points in point order from 0 and divides
# by max(count, 1), the plain serial scatter's order and rounding. VOX_ATOL
# holds only its library yardstick, whose index_add_ adds each voxel's
# points in a run-dependent order.
VOX_ATOL = 1e-5
INTERP_ATOL = 1e-5  # K3: the weighted sum and weights round like the plain version's to a few ulp
POSE_ATOL = 1e-4   # whole path: K3's and K6's few-ulp differences feed the pose heads
# K4 and K7 sum each slot's w * g terms in ascending e = k * N + t from 0,
# as index_add_ does on the CPU: bit-equal to the plain versions run on CPU
# copies. On the card index_add_ adds in a run-dependent order, so the plain
# versions and the library calls run there are held within a tolerance: a
# sum of n terms in any order is within (n - 1) * 2^-24 of sum |terms|, and
# at most a few hundred terms land on one row of the main path: 1e-5 of
# sum |w * g| per element. K5 writes each value once: bit-equal.
INTERP_BWD_RTOL = 1e-5
# One train step, kernel path vs plain path: f32 sums in run-dependent order
# (cuDNN's, the plain versions' index_add_ on the card) move the losses by
# a few ulp and the gradient, whose f32 conditioning is poor (the neck's BN
# backward cancels nearly all of a near-uniform confidence average; see
# tests/test_torch_train_model.py), by more: losses within 1e-5 relative;
# the flat gradient within 5e-3 in relative L2 norm. On an H100 the kernel
# path differed from itself between two runs by 3.5e-4 to 5.5e-4 and from
# the plain path by 3.6e-4 to 1.2e-3; a kernel that dropped or misplaced a
# neighbour's or a voxel's gradient moves it by far more.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL_L2 = 5e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA event pair per run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, reps: int = 10, rounds: int = 3) -> float:
    """Device time of fn() in ms without the host's launch cost: `calls`
    calls captured in one CUDA graph, replayed `reps` times between one
    CUDA event pair; the median of `rounds` such pairs, as one pair alone
    can catch a slow stretch of the card. cuda_ms times the wrapper as a
    caller meets it, which for a kernel of ~0.1 ms is mostly the host's
    time to launch it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(rounds):
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / (calls * reps))
    del graph
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    """Least time on the card for the work: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def adversarial_voxel_batch(grid_shape, b: int, n: int, c: int, tile: int, seed: int = 0):
    """K1's hard inputs at the main path's shapes, as numpy (feats f32
    [b, n, c], voxel_idx int32 [b, n, 3], point mask f32 [b, n]; b >= 6):
    sample 0 puts every point in one cell; sample 1 fills the last cell and
    the cells on both sides of every tile edge; sample 2 is all masked;
    sample 3 has indices out of range on each axis (-1, D, far out);
    sample 4 crowds its points into 8 interleaved cells of one tile; the
    rest cluster around a center, with 10 % of the points masked."""
    import numpy as np

    rng = np.random.RandomState(seed)
    dims = np.asarray(grid_shape)
    g = int(np.prod(dims))
    center = rng.randint(8, dims - 8, size=(b, 1, 3))
    vidx = np.clip(center + rng.randint(-6, 7, size=(b, n, 3)), 0, dims - 1)
    feats = rng.randn(b, n, c).astype(np.float32)
    mask = (rng.rand(b, n) > 0.1).astype(np.float32)
    mask[:2] = 1.0
    vidx[0] = (dims[0] // 2, dims[1] // 3, dims[2] // 5)
    edges = [g - 1, 0] + [e for t in range(tile, g, tile) for e in (t - 1, t)]
    vidx[1] = np.stack(np.unravel_index(np.asarray(edges)[np.arange(n) % len(edges)], dims), -1)
    mask[2] = 0.0
    for axis in range(3):
        for k, bad in enumerate((-1, int(dims[axis]), -1000, 100000)):
            vidx[3, 40 * axis + 10 * k:40 * axis + 10 * k + 10, axis] = bad
    crowd = np.stack(np.unravel_index(tile + 97 * np.arange(8), dims), -1)
    vidx[4] = crowd[np.arange(n) % 8]
    return feats, vidx.astype(np.int32), mask


def check_slot_prefix(coords, vmask, occupancy, cap: int, dims, what: str) -> None:
    """K5's precondition on K2's output: the valid slots of each sample are
    [0, min(occupancy, cap)) and their linear indices rise strictly."""
    import torch

    d1, d2 = int(dims[1]), int(dims[2])
    n_valid = torch.clamp(occupancy.long(), max=cap)
    slots = torch.arange(cap, device=vmask.device)
    check(torch.equal(vmask > 0, slots[None] < n_valid[:, None]),
          f"{what}: the valid slots are not the prefix [0, min(occupancy, cap))")
    lin = (coords[..., 0].long() * d1 + coords[..., 1]) * d2 + coords[..., 2]
    both = (vmask[:, 1:] > 0) & (vmask[:, :-1] > 0)
    check(bool((lin[:, 1:] > lin[:, :-1])[both].all()),
          f"{what}: the linear indices of the valid slots do not rise strictly")


def adversarial_interp_inputs(seed: int = 0):
    """K3's hard inputs, as numpy: a list of (what, points [B, N, 3],
    centers [B, V, 3], feats [B, V, C], mask [B, V], n_valid [B] int32 or
    None). Where n_valid is given the mask is 0 from n_valid[b] on, as K2's
    output is past its occupancy.
     - "tie lattice": 2048 centers on a 16 x 16 x 8 lattice of spacing 0.25
       (exact in f32), queries on its nodes, edge and face midpoints and
       cell centers (up to 8 equidistant centers); sample 1 holds the
       lattice shuffled (tied centers far apart in j), sample 2 each of
       1024 centers twice (equal distances at neighbouring j), sample 3 a
       masked tail from 1000 on;
     - "few valid": V = 64 with 0, 1, 2 and 3 valid centers, N = 1000 (not a
       multiple of the block's queries), C = 33 (no float4 epilogue);
     - "V % 4 != 0": V = 517 (rows of odd samples start off 16 bytes, and a
       rounded-up copy would pass V), n_valid 517, 300 and 5, C = 40;
     - "non-prefix mask": half the rows masked at random, no n_valid."""
    import numpy as np

    rng = np.random.RandomState(seed)
    f32 = np.float32
    lat = (np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(8), indexing="ij"),
                    -1).reshape(-1, 3) * 0.25).astype(f32)
    centers = np.repeat(lat[None], 4, 0)
    centers[1] = lat[rng.permutation(len(lat))]
    centers[2] = np.repeat(lat[:1024], 2, 0)
    n_valid = np.asarray([2048, 2048, 2048, 1000], np.int32)
    mask = (np.arange(2048)[None] < n_valid[:, None]).astype(f32)
    offs = np.asarray([[0, 0, 0], [0.125, 0, 0], [0.125, 0.125, 0], [0.125, 0.125, 0.125]], f32)
    points = lat[rng.randint(0, len(lat), (4, 1024))] + offs[rng.randint(0, 4, (4, 1024))]
    cases = [("tie lattice", points, centers, rng.randn(4, 2048, 32).astype(f32), mask,
              n_valid)]
    n_valid = np.asarray([0, 1, 2, 3], np.int32)
    cases.append(("few valid", rng.rand(4, 1000, 3).astype(f32),
                  rng.rand(4, 64, 3).astype(f32), rng.randn(4, 64, 33).astype(f32),
                  (np.arange(64)[None] < n_valid[:, None]).astype(f32), n_valid))
    n_valid = np.asarray([517, 300, 5], np.int32)
    cases.append(("V % 4 != 0", rng.rand(3, 1000, 3).astype(f32),
                  rng.rand(3, 517, 3).astype(f32), rng.randn(3, 517, 40).astype(f32),
                  (np.arange(517)[None] < n_valid[:, None]).astype(f32), n_valid))
    cases.append(("non-prefix mask", rng.rand(2, 1024, 3).astype(f32),
                  rng.rand(2, 1024, 3).astype(f32), rng.randn(2, 1024, 64).astype(f32),
                  (rng.rand(2, 1024) > 0.5).astype(f32), None))
    return cases


def check_interp_adversarial(dev) -> None:
    """K3 on adversarial_interp_inputs: with and without n_valid the kernel's
    out, w and idx are torch.equal; against the plain version on CPU copies
    (whose argmin breaks ties to the lowest index) idx is equal and out, w
    are within INTERP_ATOL."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_interp

    for what, *arrays in adversarial_interp_inputs():
        pts, ctr, fts, msk = (torch.as_tensor(a, device=dev) for a in arrays[:4])
        nv = None if arrays[4] is None else torch.as_tensor(arrays[4], device=dev)
        got = cuda_interp.nn_interpolate_cuda(pts, ctr, fts, msk)
        if nv is not None:
            with_nv = cuda_interp.nn_interpolate_cuda(pts, ctr, fts, msk, nv)
            for a, r, name in zip(with_nv, got, ("out", "w", "idx")):
                check(torch.equal(a, r), f"K3 {what}: {name} with n_valid differs from "
                      "without")
        want = cuda_interp.nn_interpolate_reference(pts.cpu(), ctr.cpu(), fts.cpu(), msk.cpu())
        check(torch.equal(got[2].cpu(), want[2]), f"K3 {what}: idx differ from the plain "
              "version")
        for a, r, name in zip(got[:2], want[:2], ("out", "w")):
            e = max_err(a.cpu(), r)
            check(e <= INTERP_ATOL, f"K3 {what}: {name} differs by {e}")


def adversarial_fused_inputs(seed: int = 0):
    """K6's hard inputs, as numpy: a list of (what, points [B, N, 3], coords
    [B, cap, 3] int32, feats [B, cap, C], mask [B, cap], occupancy [B]
    int32, unit_s, off_c). As in K2's output the mask is 1 on the slots
    [0, min(occupancy, cap)) and 0 after.
     - "tie lattice": adversarial_interp_inputs' lattice as integer coords
       with unit_s 0.25 and off_c 0 (centers exact in f32): in order,
       shuffled, each of 1024 coords twice, and occupancy 1000 of 2048;
     - "few valid": cap 64 with occupancy 0, 1, 2 and 3, N = 1000 (not a
       multiple of the block's queries), C = 33 (no float4 epilogue);
     - "cap % 4 != 0": cap 517 with occupancy 517, 300 and 5, C = 40 (odd
       samples' rows start off 16 bytes: the plain-load path);
     - "over capacity": occupancy 300, 1000, 256 and 100 at cap 256;
     - "tile loop": one sample, cap 4096, occupancy 3000: two tiles of 2048
       rows, the second bulk copy after the first tile's in-place decode.
    The other cases' coords are random in [0, 64)^3 (repeats included) under
    the affine map of a 64^3 grid."""
    import numpy as np

    rng = np.random.RandomState(seed)
    f32, i32 = np.float32, np.int32

    def prefix(occ, cap):
        return (np.arange(cap)[None] < np.minimum(occ, cap)[:, None]).astype(f32)

    lat = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(8), indexing="ij"),
                   -1).reshape(-1, 3).astype(i32)
    coords = np.repeat(lat[None], 4, 0)
    coords[1] = lat[rng.permutation(len(lat))]
    coords[2] = np.repeat(lat[:1024], 2, 0)
    occ = np.asarray([2048, 2048, 2048, 1000], i32)
    offs = np.asarray([[0, 0, 0], [0.125, 0, 0], [0.125, 0.125, 0], [0.125, 0.125, 0.125]], f32)
    points = (lat[rng.randint(0, len(lat), (4, 1024))] * f32(0.25)
              + offs[rng.randint(0, 4, (4, 1024))]).astype(f32)
    cases = [("tie lattice", points, coords, rng.randn(4, 2048, 32).astype(f32),
              prefix(occ, 2048), occ, (0.25,) * 3, (0.0,) * 3)]
    unit_s, off_c = (0.024, 0.03, 0.018), (-0.75, -0.9, -0.6)
    lo, hi = np.asarray(off_c, f32), np.asarray(off_c, f32) + 64 * np.asarray(unit_s, f32)
    for what, b, n, cap, c, occ in (
            ("few valid", 4, 1000, 64, 33, (0, 1, 2, 3)),
            ("cap % 4 != 0", 3, 1000, 517, 40, (517, 300, 5)),
            ("over capacity", 4, 512, 256, 32, (300, 1000, 256, 100)),
            ("tile loop", 1, 600, 4096, 32, (3000,))):
        occ = np.asarray(occ, i32)
        cases.append((what, (lo + rng.rand(b, n, 3) * (hi - lo)).astype(f32),
                      rng.randint(0, 64, (b, cap, 3)).astype(i32),
                      rng.randn(b, cap, c).astype(f32), prefix(occ, cap), occ, unit_s, off_c))
    return cases


def check_fused_adversarial(dev) -> None:
    """K6 on adversarial_fused_inputs: out, w and idx torch.equal to K3 with
    n_valid (the occupancy) on the centers coords * unit_s + off_c formed on
    the card; against the plain K6 on CPU copies idx is equal and out, w
    are within INTERP_ATOL."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_fused, cuda_interp

    for what, *arrays, unit_s, off_c in adversarial_fused_inputs():
        pts, crd, fts, msk, occ = (torch.as_tensor(a, device=dev) for a in arrays)
        got = cuda_fused.compact_interpolate_cuda(pts, crd, fts, msk, occ, unit_s, off_c)
        unit, off = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (unit_s, off_c))
        want = cuda_interp.nn_interpolate_cuda(pts, crd.to(torch.float32) * unit + off, fts,
                                               msk, occ)
        for a, r, name in zip(got, want, ("out", "w", "idx")):
            check(torch.equal(a, r), f"K6 {what}: {name} differs from K2's centers -> K3")
        plain = cuda_fused.compact_interpolate_reference(
            pts.cpu(), crd.cpu(), fts.cpu(), msk.cpu(), occ.cpu(), unit_s, off_c)
        check(torch.equal(got[2].cpu(), plain[2]), f"K6 {what}: idx differ from the plain "
              "version")
        for a, r, name in zip(got[:2], plain[:2], ("out", "w")):
            e = max_err(a.cpu(), r)
            check(e <= INTERP_ATOL, f"K6 {what}: {name} differs by {e}")


def batch512_phase(entries: dict, level_outputs, card: str) -> None:
    """K2, K3 and K6 at the configs' eval batch of 512
    (configs/config_YCBV_bs32.yaml: hyper_dataloader_test.bs): each level's batch-32
    inputs repeated REPEAT times along the batch, so the backbone never runs
    at 512. Each output is torch.equal to the batch-32 output repeated; each
    kernel is timed as called and on the device, summed over the levels,
    into entries' batch512_ms, batch512_device_ms."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp

    def rep(t):
        return t.repeat(REPEAT, *([1] * (t.dim() - 1)))

    t = {"compact": [0.0, 0.0], "interp": [0.0, 0.0], "fused": [0.0, 0.0]}
    for level, (lf, lm, cap, got2, args3, got3, affine, got6) in enumerate(level_outputs):
        lf16, lm16 = rep(lf), rep(lm)
        big2 = cuda_compact.dense_to_sparse_cuda(lf16, lm16, cap)
        for a, r, what in zip(big2, got2, ("coords", "vfeats", "vmask", "occupancy")):
            check(torch.equal(a, rep(r)), f"K2 level {level} at batch {BATCH * REPEAT}: "
                  f"{what} is not the batch-{BATCH} output repeated")
        args16 = tuple(rep(a) for a in args3) + (big2[3],)
        big3 = cuda_interp.nn_interpolate_cuda(*args16)
        for a, r, what in zip(big3, got3, ("out", "w", "idx")):
            check(torch.equal(a, rep(r)), f"K3 level {level} at batch {BATCH * REPEAT}: "
                  f"{what} is not the batch-{BATCH} output repeated")
        del big3
        args6 = (args16[0], *big2, *affine)
        big6 = cuda_fused.compact_interpolate_cuda(*args6)
        for a, r, what in zip(big6, got6, ("out", "w", "idx")):
            check(torch.equal(a, rep(r)), f"K6 level {level} at batch {BATCH * REPEAT}: "
                  f"{what} is not the batch-{BATCH} output repeated")
        del big2, big6
        for key, fn in (("compact", lambda: cuda_compact.dense_to_sparse_cuda(lf16, lm16, cap)),
                        ("interp", lambda: cuda_interp.nn_interpolate_cuda(*args16)),
                        ("fused", lambda: cuda_fused.compact_interpolate_cuda(*args6))):
            t[key][0] += cuda_ms(fn, reps=10)
            t[key][1] += graph_ms(fn, calls=4, reps=5)
        del lf16, lm16, args16, args6
        torch.cuda.empty_cache()
    for key, (ms, dev_ms) in t.items():
        entries[key].update(batch512_ms=ms, batch512_device_ms=dev_ms)
        print(f"{key} at batch {BATCH * REPEAT} on {card}, 4 levels: {ms:.4f} ms (device "
              f"{dev_ms:.4f}); the outputs equal the batch-{BATCH} outputs repeated",
              flush=True)


def bit_equal_on_cpu(kernel, plain, args, what: str):
    """kernel(*args) on the card twice: the two results equal bit for bit,
    and equal bit for bit (signs of zero included) to plain(*args) run on
    CPU copies of the inputs. Returns the first result."""
    import torch

    got = kernel(*args)
    again = kernel(*args)
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"{what}: two launches on the same inputs differ")
    want = plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    check(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)),
          f"{what}: not bit-equal to the plain version on the CPU "
          f"(max abs {max_err(got.cpu(), want):.3g})")
    return got


def share_of_mass(got, ref, mass) -> float:
    """The largest |got - ref| per element, over sum |w g| of that element."""
    return float(((got - ref).abs() / mass.clamp(min=1e-30)).max())


def check_inverse_index(idx, v: int, what: str) -> None:
    """K4's and K7's inverse index on the card against its plain version on
    the CPU (a stable sort): bit-equal."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_interp

    start, ent = cuda_interp.inverse_index_cuda(idx, v)
    want_start, want_ent = cuda_interp.inverse_index_reference(idx.cpu(), v)
    check(torch.equal(start.cpu(), want_start) and torch.equal(ent.cpu(), want_ent),
          f"{what}: the inverse index is not bit-equal to its plain version")


def adversarial_bwd_inputs(g, idx, vmask, seed: int):
    """K4's and K7's hard inputs at a level's shapes, from its cotangent g
    [B, N, C], indices idx [B, 3, N] and slot mask vmask [B, cap]: sample
    0's 3N contributions all on slot 0 (as when all its points sit in one
    voxel and fewer than 3 centers are valid), sample 1's all on its last
    valid slot, the rest as given, and g of mixed magnitude (1e-3 to 1e3 by
    point) so that a sum in another order shows. Returns (g, idx)."""
    import torch

    gen = torch.Generator(device=g.device).manual_seed(seed)
    idx = idx.clone()
    idx[0] = 0
    idx[1] = max(int((vmask[1] > 0).sum()) - 1, 0)
    scale = 10.0 ** torch.randint(-3, 4, (g.shape[0], g.shape[1], 1), device=g.device,
                                  generator=gen)
    return g * scale, idx


@contextmanager
def plain_versions():
    """Route the model's seven kernel calls (K1-K3 and K6 forward, K4, K5
    and K7 backward) to their plain versions, on whatever device the
    tensors are, for the comparison runs."""
    from dcl_net_tpu_torch.models import dcl_net
    from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp, cuda_voxelize

    routes = [
        (dcl_net, "voxelize_cuda", cuda_voxelize.voxelize_reference),
        (cuda_compact, "dense_to_sparse_cuda", cuda_compact.dense_to_sparse_reference),
        (cuda_compact, "dense_to_sparse_bwd_cuda",
         cuda_compact.dense_to_sparse_bwd_reference),
        (cuda_interp, "nn_interpolate_cuda", cuda_interp.nn_interpolate_reference),
        (cuda_interp, "nn_interpolate_bwd_cuda", cuda_interp.nn_interpolate_bwd_reference),
        (cuda_fused, "compact_interpolate_cuda", cuda_fused.compact_interpolate_reference),
        (cuda_fused, "compact_interpolate_bwd_cuda",
         cuda_fused.compact_interpolate_bwd_reference),
    ]
    saved = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(routes, saved):
            setattr(mod, name, fn)


KERNEL_COUNTERS = (  # (entry name, module, counter attribute)
    ("voxelize", "cuda_voxelize", "launches"),
    ("compact", "cuda_compact", "launches"),
    ("interp", "cuda_interp", "launches"),
    ("interp_bwd", "cuda_interp", "bwd_launches"),
    ("compact_bwd", "cuda_compact", "bwd_launches"),
    ("fused", "cuda_fused", "launches"),
    ("fused_bwd", "cuda_fused", "bwd_launches"),
)
KERNEL_ORDER = tuple(k for k, _, _ in KERNEL_COUNTERS)


def expect_counts(counts: dict, per_run: dict, runs: int, what: str) -> None:
    """The launch counts of a path: per_run[k] * runs for each kernel named
    there, 0 for every other kernel."""
    want = {k: per_run.get(k, 0) * runs for k in KERNEL_ORDER}
    check(counts == want, f"{what} launch counts {counts}, expected {want}")


def _counter_module(name: str):
    import importlib

    return importlib.import_module(f"dcl_net_tpu_torch.ops.{name}")


def reset_counts() -> None:
    for _, mod, attr in KERNEL_COUNTERS:
        setattr(_counter_module(mod), attr, 0)


def read_counts() -> dict:
    return {key: getattr(_counter_module(mod), attr) for key, mod, attr in KERNEL_COUNTERS}


TWO_STAGE_TRAIN = {"voxelize": 2, "compact": 8, "interp": 8, "interp_bwd": 8,
                   "compact_bwd": 8}
FUSED_TRAIN = {"voxelize": 2, "compact": 8, "fused": 8, "fused_bwd": 8}


def train_phase(cfg, card, interp_mode="pallas", steps=TRAIN_STEPS,
                per_step=TWO_STAGE_TRAIN, device="cuda"):
    """Solver at full width: a warm-up step, then `steps` counted and timed
    steps through train_epoch. Returns (launch counts over the timed steps,
    the solver, one device batch of the run, samples/s)."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.train.solver import Solver, bn_statistics

    dev = torch.device(device)
    mcfg = cfg.model
    bs = int(cfg.hyper_dataloader_train.bs)
    check(bs == BATCH, f"config batch {bs}")
    ds = SyntheticPoseDataset(
        n_objects=N_CLASSES, n_points=int(mcfg.n_inp),
        unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
        voxel_num_limit=tuple(int(d) for d in mcfg.voxel_num_limit),
        length=bs * (steps + 1), seed=0)
    loader = BatchLoader(ds, batch_size=bs, num_workers=8, seed=int(cfg.get("rd_seed", 1)))
    model = DCLNet.from_config(mcfg, seed=0, device=dev, interp_mode=interp_mode)
    train_cfg = cfg.merge({"per_write": 1, "per_save": 0})
    solver = Solver(model, dcl_losses, train_cfg, loader, device=dev)
    solver.initialize()
    params0 = [p.detach().clone() for p in model.parameters()]
    stats0 = [b.clone() for b in bn_statistics(model)]

    # warm-up step (cuDNN algorithm choice, allocator), not counted; the
    # epoch below starts after it (skip_next), on the same shuffle
    t0 = time.perf_counter()
    first = batch_to_torch(next(iter(loader)), dev)
    warm = solver.train_step(solver.state, first)
    torch.cuda.synchronize()
    print(f"train ({interp_mode}) warm-up step {time.perf_counter() - t0:.3f} s, "
          f"loss_all {float(warm['loss_all']):.5f}", flush=True)
    loader.skip_next = 1
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    avg = solver.train_epoch()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counts()
    n = solver.state.step - 1
    check(n == steps, f"{n} timed steps")
    print(f"train ({interp_mode}) path launches {launches} over {n} steps", flush=True)
    expect_counts(launches, per_step, n, f"train ({interp_mode})")
    for key in ("loss_all", "loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "grad_norm"):
        check(bool(np.isfinite(avg[key])), f"train {key} not finite: {avg[key]}")
    check(avg["skipped_nonfinite"] == 0.0, "a training step was skipped as non-finite")
    check(all(not torch.equal(a, p) for a, p in zip(params0, model.parameters())),
          "some parameter did not change")
    check(all(not torch.equal(a, b) for a, b in zip(stats0, bn_statistics(model))),
          "some BN running statistic did not change")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = n * bs / t_train
    print(f"train ({interp_mode}) path on {card}: {n} steps of batch {bs} in "
          f"{t_train:.3f} s = {rate:.2f} samples/s, T_step mean {avg['T_step']:.4f} s, "
          f"T_data mean {avg['T_data']:.4f} s, peak memory {peak:.2f} GiB; mean loss_all "
          f"{avg['loss_all']:.5f} grad_norm {avg['grad_norm']:.3f} "
          f"overflow_frac {avg['overflow_frac']:.4f}", flush=True)
    return launches, solver, first, rate


def train_step_vs_plain(solver, batch, per_pass, two_stage=None) -> None:
    """Losses and parameter gradients of one train-mode forward and backward
    from the same state, through the kernels and through the plain
    versions, and (two_stage: a two-stage model with the same state) on the
    two-stage path. per_pass: the launches of one kernel pass. The BN
    running statistics are put back after each pass."""
    import torch

    from dcl_net_tpu_torch.models.dcl_net import dcl_losses
    from dcl_net_tpu_torch.train.solver import bn_statistics

    def one_pass(model):
        model.train()
        params = list(model.parameters())
        stats = bn_statistics(model)
        saved = [b.clone() for b in stats]
        losses = dcl_losses(model(batch), batch)
        grads = torch.autograd.grad(losses["loss_all"], params)
        with torch.no_grad():
            for b, s in zip(stats, saved):
                b.copy_(s)
        return ({k: float(v.detach()) for k, v in losses.items()},
                torch.cat([g.reshape(-1) for g in grads]))

    model = solver.model
    mode = model.point_feats_inp.interp_mode
    reset_counts()
    lk, gk = one_pass(model)
    expect_counts(read_counts(), per_pass, 1, f"one train pass ({mode})")
    lk2, gk2 = one_pass(model)
    with plain_versions():
        lp, gp = one_pass(model)
    expect_counts(read_counts(), per_pass, 2, "the plain pass launched a kernel:")

    rep = float((gk - gk2).norm()) / float(gk.norm())
    print(f"train step ({mode}) through the kernels, two passes from one state: gradient "
          f"rel L2 {rep:.3g} (bit-equal {torch.equal(gk, gk2)}), losses equal "
          f"{lk == lk2}", flush=True)

    def compare(what, lo, go):
        denom = float(go.norm())
        rel = float((gk - go).norm()) / denom
        loss_rel = max(abs(lk[k] - lo[k]) / abs(lo[k]) for k in lo)
        print(f"train step ({mode}) kernel path vs {what} on the card: losses rel "
              f"{loss_rel:.3g}, gradient rel L2 {rel:.3g} (kernel path vs itself "
              f"{float((gk - gk2).norm()) / denom:.3g}), max abs "
              f"{float((gk - go).abs().max()):.3g} of max {float(go.abs().max()):.3g}",
              flush=True)
        check(loss_rel <= TRAIN_LOSS_RTOL, f"train losses differ from {what} by {loss_rel}")
        check(rel <= TRAIN_GRAD_REL_L2,
              f"train gradients differ from {what} by {rel} in relative L2")

    compare("plain versions", lp, gp)
    if two_stage is not None:
        two_stage.load_state_dict(model.state_dict())
        lt, gt = one_pass(two_stage)
        compare("the two-stage path", lt, gt)


def stage2_train_phase(card, model_f, model_points, grid_shape, n_points,
                       device="cuda") -> None:
    """The refiner's training through Solver(step_builder=...) with
    config_YCBV_bs40.yaml's optimizer and schedule at batch
    bs // ITERATIONS, on the frozen fused stage 1: a warm-up step, then
    STAGE2_TRAIN_STEPS counted and timed steps."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.train.solver import Solver
    from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step

    dev = torch.device(device)
    cfg2 = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs40.yaml"))
    bs = int(cfg2.hyper_dataloader_train.bs) // ITERATIONS
    ds = SyntheticPoseDataset(
        n_objects=N_CLASSES, n_points=n_points,
        unit_voxel_extent=tuple(cfg2.model.unit_voxel_extent), voxel_num_limit=grid_shape,
        length=bs * (STAGE2_TRAIN_STEPS + 1), seed=0)
    loader = BatchLoader(ds, batch_size=bs, num_workers=8, seed=int(cfg2.get("rd_seed", 1)))
    cld = torch.as_tensor(np.asarray(model_points, np.float32), device=dev)
    refiner = Refiner(n_inp=n_points, seed=1)
    stage1 = {k: v.clone() for k, v in model_f.state_dict().items()}
    solver = Solver(refiner, None, cfg2.merge({"per_write": 1, "per_save": 0}), loader,
                    device=dev, step_builder=lambda opt: make_stage2_train_step(
                        model_f, refiner, opt, ITERATIONS, cld))
    solver.initialize()
    params0 = [p.detach().clone() for p in refiner.parameters()]
    t0 = time.perf_counter()
    warm = solver.train_step(solver.state, batch_to_torch(next(iter(loader)), dev))
    torch.cuda.synchronize()
    print(f"stage-2 train warm-up step {time.perf_counter() - t0:.3f} s, loss_all "
          f"{float(warm['loss_all']):.5f}", flush=True)
    loader.skip_next = 1
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    avg = solver.train_epoch()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counts()
    n = solver.state.step - 1
    check(n == STAGE2_TRAIN_STEPS, f"{n} timed stage-2 steps")
    print(f"stage-2 train launches {launches} over {n} steps", flush=True)
    # the frozen stage 1: both branches forward, no backward kernel
    expect_counts(launches, {"voxelize": 2, "compact": 8, "fused": 8}, n, "stage-2 train")
    for key in ("loss_all", "loss_last_iter", "grad_norm"):
        check(bool(np.isfinite(avg[key])), f"stage-2 {key} not finite: {avg[key]}")
    check(avg["skipped_nonfinite"] == 0.0, "a stage-2 step was skipped as non-finite")
    check(all(not torch.equal(a, p) for a, p in zip(params0, refiner.parameters())),
          "some refiner parameter did not change")
    check(all(torch.equal(v, model_f.state_dict()[k]) for k, v in stage1.items()),
          "stage-2 training changed a stage-1 weight or BN statistic")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"stage-2 train on {card}: {n} steps of batch {bs} ({ITERATIONS} refinement "
          f"steps each) in {t_train:.3f} s = {n * bs / t_train:.2f} samples/s, T_step mean "
          f"{avg['T_step']:.4f} s, T_data mean {avg['T_data']:.4f} s, peak memory "
          f"{peak:.2f} GiB; mean loss_all "
          f"{avg['loss_all']:.5f} loss_last_iter {avg['loss_last_iter']:.5f} grad_norm "
          f"{avg['grad_norm']:.3f}", flush=True)


YCBV_FRAMES = 26  # 26 frames x 21 classes = 546 rows: one full batch of 512 and one padded
# launches per encode of the stage-1 CLI: the config's point-feature path
# (two-stage) and model.interp_mode=pallas_fused
CLI_KERNELS = {None: {"voxelize": 1, "compact": 4, "interp": 4},
               "pallas_fused": {"voxelize": 1, "compact": 4, "fused": 4}}


class CliProbe:
    """Hooks on the port's Evaluator and on the readers named (classes whose
    __getitem__ reads one item: a YCB-V frame, a LineMOD row) for the CLI
    runs of a phase (set up and taken down by the phase): the poses of
    every batch Evaluator._run scores, with its valid and pad flags; the
    seconds of Evaluator.evaluate (the evaluate loop, loader waits
    included) and of the _run calls in it (each ends in a synchronise:
    evaluate copies their distances to the host right after); and the
    readers' seconds summed over the items their threads read."""

    def __init__(self, *readers):
        import threading

        self.readers = readers
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.rows, self.t_evaluate, self.t_run, self.t_read, self.frames = [], 0.0, 0.0, 0.0, 0

    def __enter__(self):
        import torch

        from dcl_net_tpu_torch.eval.evaluator import Evaluator

        self.saved = (Evaluator.evaluate, Evaluator._run)
        self.saved_getitem = [r.__getitem__ for r in self.readers]
        evaluate, run = self.saved
        probe = self

        def timed_evaluate(ev, loader):
            t0 = time.perf_counter()
            res = evaluate(ev, loader)
            torch.cuda.synchronize()
            probe.t_evaluate += time.perf_counter() - t0
            return res

        def timed_run(ev, batch):
            t0 = time.perf_counter()
            res = run(ev, batch)
            torch.cuda.synchronize()
            probe.t_run += time.perf_counter() - t0
            probe.rows.append((res["rot_pred"].cpu(), res["trans_pred"].cpu(),
                               batch["valid"].cpu(), batch["pad"].cpu()))
            return res

        def timed(getitem):
            def timed_getitem(ds, index):
                t0 = time.perf_counter()
                item = getitem(ds, index)
                with probe.lock:
                    probe.t_read += time.perf_counter() - t0
                    probe.frames += 1
                return item
            return timed_getitem

        Evaluator.evaluate, Evaluator._run = timed_evaluate, timed_run
        for reader, getitem in zip(self.readers, self.saved_getitem):
            reader.__getitem__ = timed(getitem)
        return self

    def __exit__(self, *exc):
        from dcl_net_tpu_torch.eval.evaluator import Evaluator

        Evaluator.evaluate, Evaluator._run = self.saved
        for reader, getitem in zip(self.readers, self.saved_getitem):
            reader.__getitem__ = getitem
        return False

    def scored_poses(self):
        """(rot [R, 3, 3], trans [R, 3]) of the scored rows, in loader order."""
        import torch

        rot, trans, valid, pad = (torch.cat(x) for x in zip(*self.rows))
        keep = (valid > 0) & ~(pad > 0)
        return rot[keep], trans[keep]


def ycbv_cli_phase(card: str, model, n_points: int, entries: dict) -> None:
    """The YCB-V eval CLIs at full width on a 21-class tree written here
    (scripts/ycbv_tree.py, no PIL): stage 1 at the config's eval batch of
    512 (or the largest power of two that fits, the failing batch's
    out-of-memory point printed) through tools/test_ycbv_stage1.main, on
    the two-stage and the fused path, then at batch 32, then stage 2 through
    tools/test_ycbv_stage2.main. Checks the scored and lost rows against the
    tree, the launch counts (one template-bank encode, then one observed
    encode a batch), the results file, finite poses, and the two paths'
    poses per instance within POSE_ATOL on the same inputs (one loader
    thread, so both runs draw the same points)."""
    import importlib.util
    import itertools
    import tempfile
    import traceback

    import numpy as np
    import torch

    from dcl_net_tpu_torch.data import png
    from dcl_net_tpu_torch.data.ycbv import YCBVTestDataset
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.tools import test_ycbv_stage1, test_ycbv_stage2
    from dcl_net_tpu_torch.train.checkpoints import save_checkpoint
    from dcl_net_tpu_torch.train.solver import TrainState

    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = False  # a fresh CLI process's setting
    t0 = time.perf_counter()
    so = png.build()
    print(f"PNG host library {so.name} ready in {time.perf_counter() - t0:.2f} s", flush=True)
    spec = importlib.util.spec_from_file_location("ycbv_tree", ROOT / "scripts" / "ycbv_tree.py")
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)

    with tempfile.TemporaryDirectory(prefix="dclx_ycbv_") as tmp, \
            CliProbe(YCBVTestDataset) as probe:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        tree = writer.write_tree(str(tmp / "data"), n_classes=21, n_frames=YCBV_FRAMES)
        rows, lost = tree["instances"], tree["lost"]
        print(f"YCB-V tree: {YCBV_FRAMES} frames, {rows} instances ({lost} lost) written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        stage1_ckpt = save_checkpoint(str(tmp / "stage1"), model, TrainState(opt_state={}), 1)
        refiner_ckpt = save_checkpoint(str(tmp / "refiner"), Refiner(n_inp=n_points, seed=0),
                                       TrainState(opt_state={}), 1)
        runs = itertools.count()

        def cli(tool, config, bs, workers=None, mode=None, extra=()):
            """One CLI run at eval batch bs, with `workers` loader threads
            (default: the config's) and model.interp_mode `mode` (default:
            the config's); returns (result, seconds of main, launch counts)."""
            log_root = tmp / f"log{next(runs)}"
            over = [f"hyper_dataloader_test.bs={bs}"]
            if mode is not None:
                over.append(f"model.interp_mode={mode}")
            if workers is not None:
                over.append(f"hyper_dataloader_test.num_workers={workers}")
            probe.reset()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = tool.main(["--config", str(ROOT / "configs" / config), "--path_data",
                             tree["path_data"], "--log_root", str(log_root), *extra,
                             "--override", *over])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            name = "test_ycbv_stage2" if tool is test_ycbv_stage2 else "test_ycbv_stage1"
            (saved,) = log_root.glob(f"*/results_{name}.json")
            check(json.loads(saved.read_text())["auc_mean"] == res["auc_mean"],
                  f"{saved} does not hold the run's auc_mean")
            check((res["n_scored"], res["n_lost"]) == (rows, lost),
                  f"{name} bs {bs} {mode}: n_scored {res['n_scored']} n_lost {res['n_lost']}, "
                  f"the tree holds {rows} and {lost}")
            check(bool(np.isfinite(res["auc_mean"])), f"{name}: auc_mean not finite")
            rot, trans = probe.scored_poses()
            check(rot.shape[0] == rows - lost and bool(torch.isfinite(rot).all())
                  and bool(torch.isfinite(trans).all()), f"{name}: poses not finite")
            encodes = 1 + -(-rows // bs)
            expect_counts(counts, CLI_KERNELS[mode], encodes, f"{name} bs {bs} {mode}")
            return res, seconds, counts

        stage1 = ["--checkpoint", stage1_ckpt]
        # the config's batch, halved until it fits on the card
        bs = 512
        while True:
            try:
                cli(test_ycbv_stage1, "config_YCBV_bs32.yaml", bs, extra=stage1)  # warm-up
                break
            except torch.cuda.OutOfMemoryError:
                where = traceback.format_exc().strip().splitlines()[-8:]
                print(f"stage-1 CLI at batch {bs} ran out of device memory on {card}:\n  "
                      + "\n  ".join(where), flush=True)
                torch.cuda.empty_cache()
                check(bs > 32, "the stage-1 CLI does not fit at batch 32")
                bs //= 2
        if bs < 512:
            print(f"stage-1 CLI: batch 512 does not fit in f32; largest power of two that "
                  f"fits: {bs}", flush=True)

        # timed: the config's loader threads, peak memory over the run
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, t_main, counts = cli(test_ycbv_stage1, "config_YCBV_bs32.yaml", bs, extra=stage1)
        peak = torch.cuda.max_memory_allocated()
        for key in ("voxelize", "compact", "interp"):
            entries[key]["ycbv_cli_launches"] = counts[key]
        print(f"stage-1 CLI two-stage at batch {bs} on {card}: auc_mean {res['auc_mean']} "
              f"n_scored {res['n_scored']} n_lost {res['n_lost']} n_overflow "
              f"{res['n_overflow']}; launches {counts}", flush=True)
        print(f"stage-1 CLI at batch {bs} on {card}: main {t_main:.3f} s = "
              f"{rows / t_main:.1f} instances/s end to end; evaluate loop "
              f"{probe.t_evaluate:.3f} s = {rows / probe.t_evaluate:.1f} instances/s, of which "
              f"{probe.t_run:.3f} s in the model and ADD-S and "
              f"{probe.t_evaluate - probe.t_run:.3f} s waiting on the loader; reader "
              f"{probe.t_read:.3f} s over {probe.frames} frames summed over its threads "
              f"({probe.t_read / probe.frames * 1e3:.1f} ms a frame); peak device memory "
              f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB above the "
              f"{base / 2 ** 30:.2f} GiB held before the run)", flush=True)

        # the two paths on the same inputs: one loader thread, same seed
        poses, aucs = {}, {}
        for mode in (None, "pallas_fused"):
            res_m, t_m, counts = cli(test_ycbv_stage1, "config_YCBV_bs32.yaml", bs, workers=1,
                                     mode=mode, extra=stage1)
            poses[mode], aucs[mode] = probe.scored_poses(), res_m["auc_mean"]
            if mode == "pallas_fused":
                entries["fused"]["ycbv_cli_launches"] = counts["fused"]
            print(f"stage-1 CLI {mode or 'two-stage'} at batch {bs}, 1 loader thread: "
                  f"auc_mean {res_m['auc_mean']}, main {t_m:.3f} s = {rows / t_m:.1f} "
                  f"instances/s, evaluate loop {probe.t_evaluate:.3f} s", flush=True)
        e_rot = max_err(poses[None][0], poses["pallas_fused"][0])
        e_trans = max_err(poses[None][1], poses["pallas_fused"][1])
        print(f"stage-1 CLI fused vs two-stage, {rows - lost} scored instances: rot_pred "
              f"{e_rot:.3g} trans_pred {e_trans:.3g}", flush=True)
        check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL,
              "the CLI's fused and two-stage poses disagree")

        # batch 32 on the same inputs as the two-stage run above
        res32, t32, _ = cli(test_ycbv_stage1, "config_YCBV_bs32.yaml", 32, workers=1,
                            extra=stage1)
        rot32, trans32 = probe.scored_poses()
        e32 = max(max_err(rot32, poses[None][0]), max_err(trans32, poses[None][1]))
        print(f"stage-1 CLI at batch 32, 1 loader thread: auc_mean {res32['auc_mean']} "
              f"(batch {bs}: {aucs[None]}), poses within {e32:.3g} of batch {bs}'s, "
              f"main {t32:.3f} s = {rows / t32:.1f} instances/s", flush=True)
        check(abs(res32["auc_mean"] - aucs[None]) < 0.2,
              "stage-1 CLI: batch 32 and the large batch disagree")

        # stage 2 at its config's eval batch, the refiner from a checkpoint
        res2, t2, counts2 = cli(test_ycbv_stage2, "config_YCBV_bs40.yaml", bs,
                                extra=["--checkpoint_stage1", stage1_ckpt,
                                       "--checkpoint", refiner_ckpt,
                                       "--iteration", str(ITERATIONS)])
        print(f"stage-2 CLI at batch {bs} on {card}: {ITERATIONS} refinement steps, "
              f"auc_mean {res2['auc_mean']} n_scored {res2['n_scored']} n_lost "
              f"{res2['n_lost']}, main {t2:.3f} s = {rows / t2:.1f} instances/s, evaluate "
              f"loop {probe.t_evaluate:.3f} s; launches {counts2}", flush=True)
    print(f"YCB-V CLI phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


LM_FRAMES, LM_REPEATS = 8, 5     # 13 objects x 8 frames x 5 = 520 eval rows (65 lost), 104 train
LMO_IMAGES, LMO_REPEATS = 5, 13  # 8 objects x 5 images x 13 = 520 rows, 40 lost
LM_TRAIN_STEPS = 3               # one epoch of the 104 train rows at batch 32
LM_CAPACITIES = (8192, 4096, 512, 64)  # above the trees' K2 rows at 5 mm; 512, 64: whole grids
LEVEL_SIDES = (32, 16, 8, 4)     # the grids of the 4 pyramid levels at 64^3


class OccupancyProbe:
    """Records K2's occupancy (rows kept) of every dense_to_sparse call on
    the two-stage path: (batch size, grid side, occupancy [B])."""

    def __enter__(self):
        from dcl_net_tpu_torch.ops import cuda_compact

        self.calls = []
        self.saved = cuda_compact.dense_to_sparse
        saved, calls = self.saved, self.calls

        def probe(feats, mask, capacity):
            out = saved(feats, mask, capacity)
            calls.append((int(feats.shape[0]), int(feats.shape[1]), out[3].cpu()))
            return out

        cuda_compact.dense_to_sparse = probe
        return self

    def __exit__(self, *exc):
        from dcl_net_tpu_torch.ops import cuda_compact

        cuda_compact.dense_to_sparse = self.saved
        return False

    def levels(self, batch: int, keep=None, caps=(2048, 1024, 512, 64)) -> str:
        """Mean / max occupancy per level over the first encode of `batch`
        rows (its rows where keep is true), with each level's capacity."""
        first = [c for c in self.calls if c[0] == batch][:4]
        check([side for _, side, _ in first] == list(LEVEL_SIDES),
              f"K2 calls at batch {batch}: {[c[:2] for c in first]}")
        parts = []
        for (_, side, occ), cap in zip(first, caps):
            occ = occ[keep] if keep is not None else occ
            parts.append(f"{side}^3 {occ.float().mean().item():.1f} / {int(occ.max())} "
                         f"(cap {cap}, {int((occ > cap).sum())} over)")
        return ", ".join(parts)


def seeded_reference_state_dict(shapes: dict, seed: int) -> dict:
    """A reference-layout state dict (the keys and shapes given) of seeded
    random numpy weights at trainable scales: spconv kernels and 1x1 convs
    N(0, 2 / fan_in), BN weights 1 + N(0, 0.01), biases and running means
    N(0, 0.01), running variances U(0.5, 1.5)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    sd = {}
    for key, shape in sorted(shapes.items()):
        if key.endswith("num_batches_tracked"):
            sd[key] = np.array(100, np.int64)
        elif key.endswith("running_var"):
            sd[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif key.endswith(("running_mean", "bias")):
            sd[key] = (0.1 * rng.randn(*shape)).astype(np.float32)
        elif len(shape) == 1:  # a BN weight
            sd[key] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:  # spconv [kz,ky,kx,Cin,Cout], Conv3d 1x1 [Cout,Cin,1,1,1], Conv1d [Cout,Cin,1]
            fan_in = shape[1] if shape[-1] == 1 else int(np.prod(shape[:-1]))
            sd[key] = (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    return sd


def lm_phase(card: str, entries: dict) -> None:
    """The LineMOD family and reference weights at full width: writes a
    LineMOD and an Occlusion-LineMOD tree (scripts/lm_tree.py, no PIL), runs
    tools/test_lm.main and tools/test_lmo.main with configs/config_LM.yaml
    (5 mm voxels) at its eval batch of 512 and a checkpoint of a seeded
    model: timed with the config's loader threads (instances/s, the loop's
    wait on the loader, peak memory), then on the two-stage and the fused
    path with one loader thread (poses per instance within POSE_ATOL), K2's
    rows per level printed, and test_lm with capacities above those rows
    (no overflow). Then test_lm through a reference .pth of seeded
    weights and through the port checkpoint converted from it (poses
    torch.equal), and 3 training steps of tools/train_stage1.main on the LM
    tree at batch 32. Checks the scored and lost rows against the trees,
    the results files and the launch counts."""
    import importlib.util
    import itertools
    import tempfile

    import numpy as np
    import torch

    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.linemod import LineMODDataset, OcclusionLineMODDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.tools import test_lm, test_lmo, train_stage1
    from dcl_net_tpu_torch.train.checkpoints import (
        load_reference_weights, save_checkpoint, to_reference_state_dict,
    )
    from dcl_net_tpu_torch.train.solver import TrainState

    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = False  # a fresh CLI process's setting
    config = str(ROOT / "configs" / "config_LM.yaml")
    cfg = Config.fromfile(config)
    spec = importlib.util.spec_from_file_location("lm_tree", ROOT / "scripts" / "lm_tree.py")
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)

    with tempfile.TemporaryDirectory(prefix="dclx_lm_") as tmp, \
            CliProbe(LineMODDataset, OcclusionLineMODDataset) as probe:
        tmp = Path(tmp)
        data = str(tmp / "data")
        t0 = time.perf_counter()
        lm_info = writer.write_lm_tree(data, frames=LM_FRAMES, repeats=LM_REPEATS)
        lmo_info = writer.write_lmo_tree(data, images=LMO_IMAGES, repeats=LMO_REPEATS)
        trees = {"test_lm": lm_info, "test_lmo": lmo_info}
        print(f"LineMOD tree: {lm_info['eval_rows']} eval rows ({lm_info['lost']} lost), "
              f"{lm_info['train_rows']} train rows; Occlusion-LineMOD tree: "
              f"{lmo_info['eval_rows']} rows ({lmo_info['lost']} lost); written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        model = DCLNet.from_config(cfg.model, seed=0)
        ckpt = save_checkpoint(str(tmp / "lm_model"), model, TrainState(opt_state={}), 1)
        del model
        runs = itertools.count()

        def cli(tool, bs, workers=None, mode=None, checkpoint=ckpt, extra=()):
            """One eval CLI run (`extra`: more config overrides); returns
            (result, seconds of main, launch counts)."""
            name = tool.__name__.rsplit(".", 1)[-1]
            rows, lost = trees[name]["eval_rows"], trees[name]["lost"]
            log_root = tmp / f"log{next(runs)}"
            over = [f"hyper_dataloader_test.bs={bs}", *extra]
            if mode is not None:
                over.append(f"model.interp_mode={mode}")
            if workers is not None:
                over.append(f"hyper_dataloader_test.num_workers={workers}")
            probe.reset()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = tool.main(["--config", config, "--path_data", data, "--log_root",
                             str(log_root), "--checkpoint", checkpoint, "--override", *over])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            (saved,) = log_root.glob(f"*/results_{name}.json")
            saved = json.loads(saved.read_text())
            check(saved["success_mean"] == res["success_mean"]
                  and saved["count_per_class"] == res["count_per_class"],
                  f"{name}: the results file does not hold the run's scores")
            # LM skips a lost row; LMO counts it in its object's denominator
            counted = rows - lost if name == "test_lm" else rows
            check((res["n_scored"], res["n_lost"], sum(res["count_per_class"]))
                  == (rows - lost, lost, counted),
                  f"{name} bs {bs} {mode}: n_scored {res['n_scored']} n_lost {res['n_lost']} "
                  f"counted {sum(res['count_per_class'])}; the tree holds {rows}, {lost} lost")
            check(0.0 <= res["success_mean"] <= 1.0, f"{name}: success_mean {res['success_mean']}")
            rot, trans = probe.scored_poses()
            check(rot.shape[0] == rows - lost and bool(torch.isfinite(rot).all())
                  and bool(torch.isfinite(trans).all()), f"{name}: poses not finite")
            expect_counts(counts, CLI_KERNELS[mode], 1 + -(-rows // bs), f"{name} bs {bs} {mode}")
            return res, seconds, counts

        for tool in (test_lm, test_lmo):
            name = tool.__name__.rsplit(".", 1)[-1]
            rows, lost = trees[name]["eval_rows"], trees[name]["lost"]
            # timed: the config's loader threads, peak memory over the run
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res, t_main, counts = cli(tool, 512)
            peak = torch.cuda.max_memory_allocated()
            for key in ("voxelize", "compact", "interp"):
                entries[key][f"{name}_cli_launches"] = counts[key]
            print(f"{name} CLI two-stage at batch 512 on {card}: success_mean "
                  f"{res['success_mean']:.4f} n_scored {res['n_scored']} n_lost "
                  f"{res['n_lost']} n_overflow {res['n_overflow']}; launches {counts}", flush=True)
            print(f"{name} CLI at batch 512 on {card}: main {t_main:.3f} s = "
                  f"{rows / t_main:.1f} instances/s end to end; evaluate loop "
                  f"{probe.t_evaluate:.3f} s = {rows / probe.t_evaluate:.1f} instances/s, of "
                  f"which {probe.t_run:.3f} s in the model and distances and "
                  f"{probe.t_evaluate - probe.t_run:.3f} s waiting on the loader; reader "
                  f"{probe.t_read:.3f} s over {probe.frames} rows summed over its threads "
                  f"({probe.t_read / probe.frames * 1e3:.1f} ms a row); peak device memory "
                  f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB above the "
                  f"{base / 2 ** 30:.2f} GiB held before the run)", flush=True)

            # the two paths on the same draws: one loader thread, same seed
            poses = {}
            for mode in (None, "pallas_fused"):
                with OccupancyProbe() as occ:
                    res_m, t_m, counts = cli(tool, 512, workers=1, mode=mode)
                poses[mode] = probe.scored_poses()
                if mode is None:
                    valid = probe.rows[0][2] > 0
                    n_classes = 13 if name == "test_lm" else 8
                    print(f"{name} K2 rows per level (mean / max), observed branch, the "
                          f"{int(valid.sum())} valid rows of the first batch of 512: "
                          f"{occ.levels(512, valid)}; template branch, {n_classes} "
                          f"objects: {occ.levels(n_classes)}; n_overflow "
                          f"{res_m['n_overflow']}", flush=True)
                else:
                    entries["fused"][f"{name}_cli_launches"] = counts["fused"]
                check(res_m["n_overflow"] == res["n_overflow"], f"{name}: n_overflow differs")
                print(f"{name} CLI {mode or 'two-stage'} at batch 512, 1 loader thread: "
                      f"success_mean {res_m['success_mean']:.4f}, main {t_m:.3f} s = "
                      f"{rows / t_m:.1f} instances/s, evaluate loop {probe.t_evaluate:.3f} s",
                      flush=True)
            e_rot = max_err(poses[None][0], poses["pallas_fused"][0])
            e_trans = max_err(poses[None][1], poses["pallas_fused"][1])
            print(f"{name} CLI fused vs two-stage, {rows - lost} scored instances: rot_pred "
                  f"{e_rot:.3g} trans_pred {e_trans:.3g}", flush=True)
            check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL,
                  f"{name}: the fused and two-stage poses disagree")

        # the default capacities overflow at 5 mm on LineMOD-sized objects:
        # capacities above the rows K2 was asked for keep every voxel
        caps = LM_CAPACITIES
        with OccupancyProbe() as occ:
            res_c, t_c, _ = cli(test_lm, 512, workers=1,
                                extra=[f"model.capacities=[{','.join(map(str, caps))}]"])
        print(f"test_lm CLI with model.capacities {list(caps)}, 1 loader thread: success_mean "
              f"{res_c['success_mean']:.4f} n_overflow {res_c['n_overflow']}, main {t_c:.3f} s "
              f"= {lm_info['eval_rows'] / t_c:.1f} instances/s; K2 rows per level, observed "
              f"branch: {occ.levels(512, probe.rows[0][2] > 0, caps)}", flush=True)
        check(res_c["n_overflow"] == 0, f"test_lm overflows capacities {caps}")

        # a reference .pth of seeded weights, then the port checkpoint converted from it
        shapes = {k: v.shape for k, v in
                  to_reference_state_dict(DCLNet.from_config(cfg.model, seed=0)).items()}
        pth = str(tmp / "reference.pth")
        torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in
                                         seeded_reference_state_dict(shapes, seed=7).items()}},
                   pth)
        res_pth, t_pth, _ = cli(test_lm, 512, workers=1, checkpoint=pth)
        poses_pth = probe.scored_poses()
        converted = load_reference_weights(DCLNet.from_config(cfg.model, seed=1), pth)
        ckpt_conv = save_checkpoint(str(tmp / "converted"), converted, TrainState(opt_state={}), 1)
        del converted
        res_conv, _, _ = cli(test_lm, 512, workers=1, checkpoint=ckpt_conv)
        poses_conv = probe.scored_poses()
        same = (torch.equal(poses_pth[0], poses_conv[0])
                and torch.equal(poses_pth[1], poses_conv[1]))
        print(f"test_lm CLI from a reference .pth on {card}: success_mean "
              f"{res_pth['success_mean']:.4f}, main {t_pth:.3f} s; the converted port "
              f"checkpoint's poses torch.equal: {same}", flush=True)
        check(same and res_pth == res_conv,
              "the .pth run and the converted checkpoint's run disagree")

        # training: one epoch of the LM train rows at the config's batch
        bs = int(cfg.hyper_dataloader_train.bs)
        log_root = tmp / "train"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        train_stage1.main(["--config", config, "--path_data", data, "--log_root", str(log_root),
                           "--override", "max_epoch=1", "per_write=1"])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        (exp_dir,) = log_root.glob("*")
        records = [json.loads(line) for line in
                   (exp_dir / "scalars.jsonl").read_text().strip().splitlines()]
        check(len(records) == LM_TRAIN_STEPS == lm_info["train_rows"] // bs,
              f"LM training wrote {len(records)} step records")
        for rec in records:
            for key in ("loss_all", "loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "grad_norm"):
                check(bool(np.isfinite(rec[key])), f"LM training {key} not finite: {rec[key]}")
            check(rec["skipped_nonfinite"] == 0.0, "an LM training step was skipped")
        expect_counts(counts, TWO_STAGE_TRAIN, LM_TRAIN_STEPS, "LM training")
        for key, n in counts.items():
            if n:
                entries[key]["lm_train_launches"] = n
        state = torch.load(exp_dir / "epoch_1" / "state.pt", map_location="cpu",
                           weights_only=True)
        init = DCLNet.from_config(cfg.model, seed=int(cfg.get("rd_seed", 1)), device="cpu")
        names = dict(init.named_parameters())
        unchanged = [k for k, v in init.state_dict().items() if k in names
                     and torch.equal(v, state["model"][k])]
        check(state["step"] == LM_TRAIN_STEPS and not unchanged,
              f"LM training: step {state['step']}, parameters unchanged: {unchanged[:4]}")
        print(f"LM training on {card}: {LM_TRAIN_STEPS} steps of batch {bs} in {t_train:.3f} s "
              f"(the reader, cuDNN's autotuning and a checkpoint included); losses "
              f"{[round(r['loss_all'], 5) for r in records]}, grad_norm "
              f"{[round(r['grad_norm'], 3) for r in records]}, overflow_frac "
              f"{[r['overflow_frac'] for r in records]}, T_step "
              f"{[round(r['T_step'], 4) for r in records]} s; peak memory {peak:.2f} GiB; "
              f"launches {counts}", flush=True)
    print(f"LineMOD phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "dcl_net_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(dcl_net_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.eval.evaluator import Evaluator, Stage2Evaluator
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.ops import (
        cuda_build, cuda_compact, cuda_fused, cuda_interp, cuda_voxelize,
    )
    from dcl_net_tpu_torch.ops.sparse_conv import voxel_centers

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(card, flush=True)
    strict_f32()
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    so = cuda_build.build(verbose=True)
    cuda_build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- inputs of the main path ------------------------------------------
    cfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml"))
    mcfg = cfg.model
    grid_shape = tuple(int(d) for d in mcfg.voxel_num_limit)
    n_points = int(mcfg.n_inp)
    ds = SyntheticPoseDataset(
        n_objects=N_CLASSES, n_points=n_points,
        unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
        voxel_num_limit=grid_shape, seed=0)
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(BATCH * N_BATCHES)]
    lost = dict(samples[-2], valid=0.0)          # one lost detection
    batches = [make_batch(samples[i * BATCH:(i + 1) * BATCH]).to_dict()
               for i in range(N_BATCHES - 1)]
    batches.append(make_batch(samples[(N_BATCHES - 1) * BATCH:-2] + [lost],
                              pad_to=BATCH).to_dict())  # and one pad row
    bank = ds.template_bank()
    model_points = np.stack(
        [ds.model_points(c, MODEL_POINTS) for c in range(N_CLASSES)])
    print(f"data: {len(batches)} batches of {BATCH} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    model = DCLNet.from_config(mcfg, seed=0)
    check(next(model.parameters()).is_cuda, "model is not on the card")
    # the same weights on the fused point-feature path
    model_f = DCLNet.from_config(mcfg, seed=0, interp_mode="pallas_fused")

    # ---- 3. kernels vs plain versions at main-path shapes -------------------
    tb = batch_to_torch(batches[0], dev)
    feats, vidx = tb["inp"]["feats"], tb["inp"]["voxel_idx"]
    entries = {}

    b_, n_, c_ = feats.shape
    for mode in (3, 4):  # the main-path batch (mode 4), and the sum mode
        grid, count = cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, mode)
        pgrid, pcount = cuda_voxelize.voxelize_reference(feats, vidx, grid_shape, mode)
        check(torch.equal(count, pcount) and torch.equal(grid, pgrid),
              f"K1 mode {mode}: grid or counts not bit-equal to the plain version")
    e1 = max_err(grid, pgrid)
    # the adversarial batch, with and without its point mask
    a_feats, a_vidx, a_mask = (torch.as_tensor(x, device=dev) for x in adversarial_voxel_batch(
        grid_shape, b_, n_, c_, cuda_voxelize.TILE))
    for mode in (3, 4):
        for pm in (a_mask, None):
            got = cuda_voxelize.voxelize_cuda(a_feats, a_vidx, grid_shape, mode, pm)
            want = cuda_voxelize.voxelize_reference(a_feats, a_vidx, grid_shape, mode, pm)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"K1 mode {mode} on the adversarial batch (mask "
                  f"{pm is not None}): not bit-equal to the plain version")
    check(float(got[1][0].max()) == n_, "K1 adversarial: sample 0 is not one full cell")
    print(f"K1 bit-equal to the plain version on the main-path batch and the "
          f"adversarial batch, modes 3 and 4", flush=True)
    del a_feats, a_vidx, a_mask, got, want
    g_ = grid_shape[0] * grid_shape[1] * grid_shape[2]
    lin = (((vidx[..., 0].long() * grid_shape[1] + vidx[..., 1]) * grid_shape[2]
            + vidx[..., 2]) + torch.arange(b_, device=dev)[:, None] * g_).reshape(-1)
    ext = torch.cat([feats, torch.ones_like(feats[..., :1])], -1).reshape(-1, c_ + 1)

    def lib_sum():  # mode 3's function: the sums and counts
        return torch.zeros(b_ * g_, c_ + 1, device=dev).index_add_(0, lin, ext)

    def lib_mean():  # mode 4's: then the divide by max(count, 1)
        acc = lib_sum()
        return acc[:, :c_] / torch.clamp(acc[:, c_:], min=1.0), acc[:, c_]

    lg, lc = lib_mean()
    check(torch.equal(lc, pcount.reshape(-1)), "K1 yardstick: counts differ")
    e_lib = max_err(lg, pgrid.reshape(-1, c_))
    check(e_lib <= VOX_ATOL, f"K1 yardstick index_add_ + divide differs by {e_lib}")
    del lg, lc
    k1_ms = cuda_ms(lambda: cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 4))
    k1_dev = graph_ms(lambda: cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 4))
    k1_sum_ms = cuda_ms(lambda: cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 3))
    k1_sum_dev = graph_ms(lambda: cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 3))
    k1_plain = cuda_ms(lambda: cuda_voxelize.voxelize_reference(feats, vidx, grid_shape, 4),
                       reps=5, warmup=1)
    lib_sum_ms, lib_sum_dev = cuda_ms(lib_sum), graph_ms(lib_sum)
    lib_mean_ms, lib_mean_dev = cuda_ms(lib_mean), graph_ms(lib_mean)
    nbytes = b_ * n_ * (c_ + 3) * 4 + b_ * g_ * (c_ + 1) * 4
    flops = b_ * n_ * (c_ + 1) + int((count > 1).sum()) * c_
    bms, bby = bound(nbytes, flops)
    entries["voxelize"] = dict(
        name="voxelize", route="cuda", source="dcl_net_tpu_torch/csrc/voxelize.cu",
        replaces="dcl_net_tpu/ops/pallas_voxelize.py:76", max_abs_err=e1,
        ms=k1_ms, kernel_ms=k1_ms, device_ms=k1_dev, plain_ms=k1_plain, bound_ms=bms,
        bound_by=bby, library_ms=lib_mean_ms, library_device_ms=lib_mean_dev,
        library_call="index_add_ then divide by clamp(count, 1) (mode 4)",
        sum_mode_ms=k1_sum_ms, sum_mode_device_ms=k1_sum_dev,
        library_sum_only_ms=lib_sum_ms, library_sum_only_device_ms=lib_sum_dev)
    print(f"K1 voxelize [{b_},{n_},{c_}] -> {grid_shape}: bit-equal, mode 4 kernel "
          f"{k1_ms:.4f} ms (device {k1_dev:.4f}) against index_add_ + divide "
          f"{lib_mean_ms:.4f} ms (device {lib_mean_dev:.4f}); mode 3 kernel "
          f"{k1_sum_ms:.4f} ms (device {k1_sum_dev:.4f}) against index_add_ "
          f"{lib_sum_ms:.4f} ms (device {lib_sum_dev:.4f}), the sum-only yardstick of "
          f"earlier runs; plain {k1_plain:.4f} ms; bound {bms:.4f} ms ({bby})", flush=True)

    mask = (count > 0).to(torch.float32)
    with torch.inference_mode():
        pyramid = model.backbone_inp(grid, mask)
    pf = model.point_feats_inp
    points = feats[..., 4:7].contiguous()
    # per kernel, summed over the levels: max error, wrapper ms, device ms
    # (graph_ms), plain ms, library ms, bytes and operations of the bound
    k2, k3, k4, k5, k6, k7 = (dict(err=0.0, ms=0.0, dev=0.0, plain=0.0, lib=lib,
                                   lib_dev=lib, bytes=0.0, flops=0.0)
                              for lib in (None, None, 0.0, 0.0, None, 0.0))
    k6.update(two=0.0, dev_two=0.0)  # the centers pass + K3 that K6 replaces
    k2.update(levels=[])  # device ms per level
    k6.update(levels=[])
    # K3 on the main path's call (n_valid: K2's occupancy) and on all cap
    # rows (no n_valid, what earlier rows of the table timed)
    k3.update(levels=[], levels_all=[], dev_all=0.0, ms_all=0.0, bytes_all=0.0,
              flops_all=0.0)
    level_outputs = []  # per level: the batch-32 inputs and outputs of K2, K3 and K6
    k4.update(index_dev=0.0)  # the inverse index alone, K4's and K7's first kernel
    k7.update(index_dev=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for level, (lf, lm) in enumerate(pyramid):
        lf, lm = lf.contiguous(), lm.contiguous()
        b_, d0, d1, d2, c_ = lf.shape
        g_ = d0 * d1 * d2
        cap = min(pf.capacities[level], g_)
        affine = pf.center_affine[level]
        occ = (lm.reshape(b_, -1) > 0).sum(1)
        caps = [cap]
        if level == 0:  # a capacity below the occupancy: the overflow case
            caps.append(max(1, int(occ.min()) // 2))
        for cp in caps:
            got = cuda_compact.dense_to_sparse_cuda(lf, lm, cp)
            ref = cuda_compact.dense_to_sparse_reference(lf, lm, cp)
            for a, r, what in zip(got, ref, ("coords", "vfeats", "vmask", "occupancy")):
                check(torch.equal(a, r), f"K2 level {level} cap {cp}: {what} "
                      "not bit-equal to the plain version")
            k2["err"] = max(k2["err"], max_err(got[1], ref[1]))
            check(torch.equal(got[3] > cp, occ > cp), "K2 overflow flag wrong")
            if cp < cap:
                check(bool((got[3] > cp).any()), "K2 overflow case did not overflow")
            # K5 on this output: its precondition, then bit-equality
            check_slot_prefix(got[0], got[2], got[3], cp, (d0, d1, d2),
                              f"K2 level {level} cap {cp}")
            dv = torch.randn((b_, cp, c_), device=dev, generator=gen)
            check(torch.equal(
                cuda_compact.dense_to_sparse_bwd_cuda(dv, got[0], got[2], (d0, d1, d2)),
                cuda_compact.dense_to_sparse_bwd_reference(dv, got[0], got[2], (d0, d1, d2))),
                f"K5 level {level} cap {cp}: not bit-equal to the plain version")
            # K6 on K2's output against K2 -> voxel_centers -> K3: bit-equal
            # (K3 with n_valid, as the main path calls it, and without)
            gc, gv, gm, go = got
            gctr = voxel_centers(gc, pf.unit, pf.scale_list[level], pf.offset)
            want6 = cuda_interp.nn_interpolate_cuda(points, gctr, gv, gm, go)
            want6_all = cuda_interp.nn_interpolate_cuda(points, gctr, gv, gm)
            got6 = cuda_fused.compact_interpolate_cuda(points, gc, gv, gm, go, *affine)
            for a, r, r_all, what in zip(got6, want6, want6_all, ("out", "w", "idx")):
                check(torch.equal(a, r) and torch.equal(a, r_all),
                      f"K6 level {level} cap {cp}: {what} not bit-equal to K2 -> "
                      "voxel_centers -> K3 (with and without n_valid)")
            ref6 = cuda_fused.compact_interpolate_reference(points, gc, gv, gm, go, *affine)
            e6 = max_err(got6[0], ref6[0])
            check(e6 <= INTERP_ATOL, f"K6 level {level} cap {cp}: out differs by {e6}")
            k6["err"] = max(k6["err"], e6)
        # K5 with one sample's mask empty (no valid slot at all)
        lm_e = lm.clone()
        lm_e[0] = 0.0
        ec, _, em, eo = cuda_compact.dense_to_sparse_cuda(lf, lm_e, cap)
        check_slot_prefix(ec, em, eo, cap, (d0, d1, d2), f"K2 level {level}, empty sample")
        dv = torch.randn((b_, cap, c_), device=dev, generator=gen)
        ge = cuda_compact.dense_to_sparse_bwd_cuda(dv, ec, em, (d0, d1, d2))
        check(torch.equal(ge, cuda_compact.dense_to_sparse_bwd_reference(dv, ec, em, (d0, d1, d2)))
              and not bool(ge[0].any()), f"K5 level {level}, empty sample: not bit-equal")
        del lm_e, ec, em, eo, ge
        coords, vfeats, vmask, occ_k = got = cuda_compact.dense_to_sparse_cuda(lf, lm, cap)
        t_k = cuda_ms(lambda: cuda_compact.dense_to_sparse_cuda(lf, lm, cap))
        t_p = cuda_ms(lambda: cuda_compact.dense_to_sparse_reference(lf, lm, cap))
        d_k = graph_ms(lambda: cuda_compact.dense_to_sparse_cuda(lf, lm, cap))
        k2["dev"] += d_k
        k2["levels"].append(d_k)
        sel = torch.clamp(occ, max=cap).sum().item()
        k2["ms"] += t_k
        k2["plain"] += t_p
        k2["bytes"] += b_ * g_ * 4 + sel * c_ * 4 + b_ * cap * (c_ + 4) * 4 + b_ * 4
        print(f"K2 compact level {level} [{b_},{d0},{d1},{d2},{c_}] cap {cap} "
              f"occupancy max {int(occ.max())}: kernel {t_k:.4f} ms (device {d_k:.4f}) "
              f"plain {t_p:.4f} ms", flush=True)

        # K3 as the main path calls it (n_valid = K2's occupancy) and on all
        # cap rows: torch.equal to each other, held to the plain version
        centers = voxel_centers(coords, pf.unit, pf.scale_list[level], pf.offset)
        args3 = (points, centers, vfeats, vmask)
        out, w, idx = got3 = cuda_interp.nn_interpolate_cuda(*args3, occ_k)
        for a, r, what in zip(got3, cuda_interp.nn_interpolate_cuda(*args3),
                              ("out", "w", "idx")):
            check(torch.equal(a, r), f"K3 level {level}: {what} with n_valid differs from "
                  "without")
        pout, pw, pidx = cuda_interp.nn_interpolate_reference(*args3)
        err = max_err(out, pout)
        check(err <= INTERP_ATOL, f"K3 level {level}: out differs by {err}")
        check(max_err(w, pw) <= INTERP_ATOL, f"K3 level {level}: weights differ")
        full = (vmask.sum(1) >= 3)
        check(torch.equal(idx[full], pidx[full]), f"K3 level {level}: idx differ")
        k3["err"] = max(k3["err"], err)
        t_k = cuda_ms(lambda: cuda_interp.nn_interpolate_cuda(*args3, occ_k))
        t_all = cuda_ms(lambda: cuda_interp.nn_interpolate_cuda(*args3))
        t_p = cuda_ms(lambda: cuda_interp.nn_interpolate_reference(*args3), reps=5, warmup=1)
        d_k = graph_ms(lambda: cuda_interp.nn_interpolate_cuda(*args3, occ_k))
        d_all = graph_ms(lambda: cuda_interp.nn_interpolate_cuda(*args3))
        v_ = vfeats.shape[1]
        n_ = points.shape[1]
        sel = torch.clamp(occ_k, max=cap).sum().item()  # the rows K3 reads with n_valid
        k3["ms"] += t_k
        k3["ms_all"] += t_all
        k3["dev"] += d_k
        k3["dev_all"] += d_all
        k3["levels"].append(d_k)
        k3["levels_all"].append(d_all)
        k3["plain"] += t_p
        k3["bytes"] += (b_ * n_ * 3 + sel * (3 + 1 + c_) + b_ + b_ * n_ * c_
                        + 2 * b_ * 3 * n_) * 4
        k3["bytes_all"] += (b_ * n_ * 3 + b_ * v_ * (3 + c_ + 1) + b_ * n_ * c_
                            + 2 * b_ * 3 * n_) * 4
        k3["flops"] += 8 * n_ * sel + 5 * b_ * n_ * c_
        k3["flops_all"] += 8 * n_ * float(vmask.sum()) + 5 * b_ * n_ * c_
        print(f"K3 interp level {level} N {n_} V {v_} C {c_}: err {err:.3g}, with n_valid "
              f"kernel {t_k:.4f} ms (device {d_k:.4f}), all {v_} rows {t_all:.4f} ms (device "
              f"{d_all:.4f}); plain {t_p:.4f} ms", flush=True)

        # K6 at this level's shapes (bit-equality checked above), timed
        # beside the two-stage centers pass + K3 that it replaces
        out6, w6, idx6 = cuda_fused.compact_interpolate_cuda(points, coords, vfeats, vmask,
                                                             occ_k, *affine)
        t_k = cuda_ms(lambda: cuda_fused.compact_interpolate_cuda(
            points, coords, vfeats, vmask, occ_k, *affine))
        t_p = cuda_ms(lambda: cuda_fused.compact_interpolate_reference(
            points, coords, vfeats, vmask, occ_k, *affine), reps=5, warmup=1)
        c_unit = getattr(pf, f"center_unit{level}")
        c_shift = getattr(pf, f"center_shift{level}")
        t_two = cuda_ms(lambda: cuda_interp.nn_interpolate_cuda(
            points, coords.to(torch.float32) * c_unit + c_shift, vfeats, vmask, occ_k))
        d_k = graph_ms(lambda: cuda_fused.compact_interpolate_cuda(
            points, coords, vfeats, vmask, occ_k, *affine))
        d_two = graph_ms(lambda: cuda_interp.nn_interpolate_cuda(
            points, coords.to(torch.float32) * c_unit + c_shift, vfeats, vmask, occ_k))
        # K6 reads only the slots [0, min(occupancy, cap)) that K2 filled
        sel = torch.clamp(occ_k, max=cap).sum().item()
        k6["dev"] += d_k
        k6["levels"].append(d_k)
        k6["dev_two"] += d_two
        k6["ms"] += t_k
        k6["plain"] += t_p
        k6["two"] += t_two
        k6["bytes"] += (b_ * n_ * 3 + sel * (3 + c_ + 1) + b_ + b_ * n_ * c_
                        + 2 * b_ * 3 * n_) * 4
        k6["flops"] += 8 * n_ * sel + 5 * b_ * n_ * c_ + 6 * sel
        print(f"K6 fused level {level} N {n_} cap {v_} C {c_}: kernel {t_k:.4f} ms "
              f"(device {d_k:.4f}) plain {t_p:.4f} ms (centers pass + K3 {t_two:.4f} ms, "
              f"device {d_two:.4f})", flush=True)
        level_outputs.append((lf, lm, cap, got, args3, got3, affine, (out6, w6, idx6)))

        # K4 at this level's shapes: a cotangent of the interpolated features.
        # Bit-equal to the plain version on CPU copies and from launch to
        # launch, on these inputs and on the adversarial set, with its
        # inverse index; within sum |w g| of the plain version and of
        # index_add_ on the card
        g = torch.randn((b_, n_, c_), device=dev, generator=gen)
        adv4 = adversarial_bwd_inputs(g, idx, vmask, seed=level)
        for gi, ii, what in ((g, idx, ""), (*adv4, ", adversarial")):
            check_inverse_index(ii, v_, f"K4 level {level}{what}")
            bit_equal_on_cpu(cuda_interp.nn_interpolate_bwd_cuda,
                             cuda_interp.nn_interpolate_bwd_reference, (gi, w, ii, v_),
                             f"K4 level {level}{what}")
        got4 = cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, v_)
        ref4 = cuda_interp.nn_interpolate_bwd_reference(g, w, idx, v_)
        mass = cuda_interp.nn_interpolate_bwd_reference(g.abs(), w.abs(), idx, v_)
        rows = (idx.long() + v_ * torch.arange(b_, device=dev)[:, None, None]).reshape(-1)
        terms = (w[..., None] * g[:, None]).reshape(-1, c_)

        def lib4():
            return torch.zeros(b_ * v_, c_, device=dev).index_add_(0, rows, terms)

        err = max_err(got4, ref4)
        rel, rel_l = (share_of_mass(a, ref4, mass) for a in (got4, lib4().reshape(ref4.shape)))
        check(rel <= INTERP_BWD_RTOL, f"K4 level {level}: differs from the plain version on "
              f"the card by {rel:.3g} of sum |w g| (max abs {err:.3g})")
        check(rel_l <= INTERP_BWD_RTOL, f"K4 level {level}: the index_add_ call computes "
              f"another function ({rel_l:.3g} of sum |w g|)")
        t_k = cuda_ms(lambda: cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, v_))
        t_p = cuda_ms(lambda: cuda_interp.nn_interpolate_bwd_reference(g, w, idx, v_))
        t_l = cuda_ms(lib4)
        k4["dev"] += graph_ms(lambda: cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, v_))
        k4["index_dev"] += graph_ms(lambda: cuda_interp.inverse_index_cuda(idx, v_))
        k4["lib_dev"] += graph_ms(lib4)
        k4["ms"] += t_k
        k4["plain"] += t_p
        k4["lib"] += t_l
        k4["bytes"] += (b_ * n_ * c_ + 2 * b_ * 3 * n_ + b_ * v_ * c_) * 4
        k4["flops"] += 6 * b_ * n_ * c_
        print(f"K4 interp_bwd level {level} N {n_} V {v_} C {c_}: bit-equal to the plain "
              f"version on the CPU (and on the adversarial set), within {rel:.3g} of sum "
              f"|w g| of it on the card; kernel {t_k:.4f} ms plain {t_p:.4f} ms "
              f"index_add_ {t_l:.4f} ms", flush=True)

        # K5 at this level's shapes: a cotangent of the compacted features
        dv = torch.randn((b_, cap, c_), device=dev, generator=gen)
        got5 = cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask, (d0, d1, d2))
        ref5 = cuda_compact.dense_to_sparse_bwd_reference(dv, coords, vmask, (d0, d1, d2))
        check(torch.equal(got5, ref5), f"K5 level {level}: not bit-equal to the plain version")
        valid = vmask.reshape(-1) > 0
        lin = (((coords[..., 0].long() * d1 + coords[..., 1]) * d2 + coords[..., 2])
               + g_ * torch.arange(b_, device=dev)[:, None]).reshape(-1)[valid]
        vals = dv.reshape(-1, c_)[valid]
        t_k = cuda_ms(lambda: cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask,
                                                                    (d0, d1, d2)))
        t_p = cuda_ms(lambda: cuda_compact.dense_to_sparse_bwd_reference(dv, coords, vmask,
                                                                         (d0, d1, d2)))

        def lib5():
            return torch.zeros(b_ * g_, c_, device=dev).index_copy_(0, lin, vals)

        t_l = cuda_ms(lib5)
        k5["dev"] += graph_ms(lambda: cuda_compact.dense_to_sparse_bwd_cuda(
            dv, coords, vmask, (d0, d1, d2)))
        k5["lib_dev"] += graph_ms(lib5)
        n_valid = int(valid.sum())
        k5["ms"] += t_k
        k5["plain"] += t_p
        k5["lib"] += t_l
        k5["bytes"] += (n_valid * c_ + b_ * cap * 4 + b_ * g_ * c_) * 4
        print(f"K5 compact_bwd level {level} [{b_},{cap},{c_}] -> {d0}^3: bit-equal, "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} ms index_copy_ {t_l:.4f} ms", flush=True)

        # K7 at this level's shapes, from K6's w and idx: held as K4 is
        g7 = torch.randn((b_, n_, c_), device=dev, generator=gen)
        grid3 = (d0, d1, d2)
        adv7 = adversarial_bwd_inputs(g7, idx6, vmask, seed=10 + level)
        for gi, ii, what in ((g7, idx6, ""), (*adv7, ", adversarial")):
            check_inverse_index(ii, cap, f"K7 level {level}{what}")
            bit_equal_on_cpu(cuda_fused.compact_interpolate_bwd_cuda,
                             cuda_fused.compact_interpolate_bwd_reference,
                             (gi, w6, ii, coords, vmask, grid3), f"K7 level {level}{what}")
        got7 = cuda_fused.compact_interpolate_bwd_cuda(g7, w6, idx6, coords, vmask, grid3)
        ref7 = cuda_fused.compact_interpolate_bwd_reference(g7, w6, idx6, coords, vmask, grid3)
        mass7 = cuda_fused.compact_interpolate_bwd_reference(g7.abs(), w6.abs(), idx6,
                                                             coords, vmask, grid3)
        # the library call: w g of each neighbour of a valid slot, added
        # into the grid cell of that slot by one index_add_
        nb = idx6.long().reshape(b_, 3 * n_)
        cell = torch.gather(coords, 1, nb[..., None].expand(-1, -1, 3)).long()
        rows7 = (((cell[..., 0] * d1 + cell[..., 1]) * d2 + cell[..., 2])
                 + g_ * torch.arange(b_, device=dev)[:, None]).reshape(-1)
        terms7 = ((w6 * torch.gather(vmask, 1, nb).reshape(b_, 3, n_))[..., None]
                  * g7[:, None]).reshape(-1, c_)

        def lib7():
            return torch.zeros(b_ * g_, c_, device=dev).index_add_(0, rows7, terms7)

        err = max_err(got7, ref7)
        rel, rel_l = (share_of_mass(a, ref7, mass7) for a in (got7, lib7().reshape(ref7.shape)))
        check(rel <= INTERP_BWD_RTOL, f"K7 level {level}: differs from the plain version on "
              f"the card by {rel:.3g} of sum |w g| (max abs {err:.3g})")
        check(rel_l <= INTERP_BWD_RTOL, f"K7 level {level}: the index_add_ call computes "
              f"another function ({rel_l:.3g} of sum |w g|)")
        t_k = cuda_ms(lambda: cuda_fused.compact_interpolate_bwd_cuda(
            g7, w6, idx6, coords, vmask, grid3))
        t_p = cuda_ms(lambda: cuda_fused.compact_interpolate_bwd_reference(
            g7, w6, idx6, coords, vmask, grid3))
        t_l = cuda_ms(lib7)
        k7["dev"] += graph_ms(lambda: cuda_fused.compact_interpolate_bwd_cuda(
            g7, w6, idx6, coords, vmask, grid3))
        k7["index_dev"] += graph_ms(lambda: cuda_interp.inverse_index_cuda(idx6, cap))
        k7["lib_dev"] += graph_ms(lib7)
        k7["ms"] += t_k
        k7["plain"] += t_p
        k7["lib"] += t_l
        k7["bytes"] += (b_ * n_ * c_ + 2 * b_ * 3 * n_ + n_valid * 4 + b_ * g_ * c_) * 4
        k7["flops"] += 6 * b_ * n_ * c_
        print(f"K7 fused_bwd level {level} [{b_},{n_},{c_}] -> {d0}^3: bit-equal to the "
              f"plain version on the CPU (and on the adversarial set), within {rel:.3g} of "
              f"sum |w g| of it on the card; kernel {t_k:.4f} ms plain {t_p:.4f} ms "
              f"index_add_ {t_l:.4f} ms", flush=True)
    csrc = "dcl_net_tpu_torch/csrc/"
    for key, acc, src, rep in (
            ("compact", k2, csrc + "compact.cu", "dcl_net_tpu/ops/pallas_compact.py:79"),
            ("interp", k3, csrc + "interp.cu", "dcl_net_tpu/ops/pallas_interp.py:42"),
            ("interp_bwd", k4, csrc + "interp.cu", "dcl_net_tpu/ops/pallas_interp.py:87"),
            ("compact_bwd", k5, csrc + "compact.cu", "dcl_net_tpu/ops/pallas_compact.py:226"),
            ("fused", k6, csrc + "fused.cu", "dcl_net_tpu/ops/pallas_fused.py:45"),
            ("fused_bwd", k7, csrc + "fused.cu", "dcl_net_tpu/ops/pallas_fused.py:182")):
        bms, bby = bound(acc["bytes"], acc["flops"])
        entries[key] = dict(
            name=key, route="cuda", source=src,
            replaces=rep, max_abs_err=acc["err"], ms=acc["ms"],
            kernel_ms=acc["ms"], device_ms=acc["dev"], plain_ms=acc["plain"],
            bound_ms=bms, bound_by=bby, library_ms=acc["lib"],
            library_device_ms=acc["lib_dev"])
        if "index_dev" in acc:  # K4 and K7: their first kernel, the inverse index
            entries[key]["index_device_ms"] = acc["index_dev"]
        if "levels" in acc:  # K2, K3 and K6: per level, and the host's share of a call
            entries[key]["level_device_ms"] = acc["levels"]
            entries[key]["host_us_per_call"] = (acc["ms"] - acc["dev"]) / 4 * 1e3
        print(f"{key} over the 4 levels of one branch: kernel {acc['ms']:.4f} ms "
              f"(device {acc['dev']:.4f}) plain {acc['plain']:.4f} ms library "
              f"{acc['lib']} ms (device {acc['lib_dev']}) bound {bms:.4f} ms ({bby})",
              flush=True)
    bms_all, _ = bound(k3["bytes_all"], k3["flops_all"])
    entries["interp"].update(
        ms_all_rows=k3["ms_all"], device_ms_all_rows=k3["dev_all"],
        level_device_ms_all_rows=k3["levels_all"], bound_all_rows_ms=bms_all)
    for key in ("compact", "interp", "fused"):
        e = entries[key]
        print(f"{key} device ms per level {', '.join(f'{t:.4f}' for t in e['level_device_ms'])}"
              f"; host overhead {e['host_us_per_call']:.1f} us a call", flush=True)
    print(f"interp on all cap rows (no n_valid): kernel {k3['ms_all']:.4f} ms (device "
          f"{k3['dev_all']:.4f}; per level {', '.join(f'{t:.4f}' for t in k3['levels_all'])}) "
          f"bound {bms_all:.4f} ms", flush=True)
    check_interp_adversarial(dev)
    print("K3 on the adversarial set (tie lattices, 0-3 valid centers, N = 1000, V = 517, "
          "a non-prefix mask): idx equal to the plain version's, out and w within "
          f"{INTERP_ATOL}, with n_valid torch.equal to without", flush=True)
    check_fused_adversarial(dev)
    print("K6 on the adversarial set in coords form (tie lattices, 0-3 valid slots, N = "
          "1000, cap 517, occupancy above cap, 3000 of 4096 slots): torch.equal to K3 with "
          f"n_valid on the decoded centers, idx equal to the plain version's, out and w within "
          f"{INTERP_ATOL}", flush=True)
    batch512_phase(entries, level_outputs, card)
    del level_outputs
    print(f"fused over the 4 levels: centers pass + K3 (the two-stage path) "
          f"{k6['two']:.4f} ms (device {k6['dev_two']:.4f})", flush=True)
    # one encode's point-feature stage (4 levels: K2, then centers + K3 or K6)
    with torch.inference_mode():
        pf_ms = {name: (cuda_ms(lambda: m.point_feats_inp(points, pyramid)),
                        graph_ms(lambda: m.point_feats_inp(points, pyramid), calls=4))
                 for name, m in (("two-stage", model), ("fused", model_f))}
    print(f"point-feature stage of one encode [{BATCH},{n_points}] on {card}: " + ", ".join(
        f"{name} {t:.4f} ms (device {d:.4f})" for name, (t, d) in pf_ms.items()), flush=True)

    # ---- 4. main path at full width ------------------------------------------
    # warm-up pass (cuDNN algorithm choice, allocator), not counted
    Evaluator(model, model_points, template_bank=bank).evaluate(batches[:1])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ev = Evaluator(model, model_points, template_bank=bank)
    torch.cuda.synchronize()
    t_bank = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ev.evaluate(batches)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = read_counts()
    encodes = 1 + len(batches)  # the template bank once, then one per batch
    print(f"eval path launches {launches} over {encodes} encodes", flush=True)
    expect_counts(launches, {"voxelize": 1, "compact": 4, "interp": 4}, encodes, "eval")
    for key, n in launches.items():
        entries[key]["eval_launches"] = n
    rows = BATCH * len(batches)
    check(res["n_scored"] == rows - 1, f"n_scored {res['n_scored']} != {rows - 1}")
    check(bool(np.isfinite(res["auc_mean"])), "auc_mean is not finite")
    inst_s = rows / t_eval
    print(f"main path on {card}: auc_mean {res['auc_mean']} n_scored {res['n_scored']} "
          f"n_overflow {res['n_overflow']} template bank {t_bank:.3f} s, "
          f"evaluate {t_eval:.3f} s for {rows} rows = {inst_s:.1f} instances/s",
          flush=True)

    tb = batch_to_torch(batches[1], dev)
    out = ev._run(tb)
    rot, trans = out["rot_pred"], out["trans_pred"]
    check(bool(torch.isfinite(rot).all() and torch.isfinite(trans).all()
               and torch.isfinite(out["adds"]).all()), "non-finite outputs")
    check(tuple(rot.shape) == (BATCH, 3, 3) and tuple(trans.shape) == (BATCH, 3),
          "output shapes")
    eye = torch.eye(3, device=dev)
    ortho = max_err(rot.transpose(1, 2) @ rot, eye.expand_as(rot))
    check(ortho < 1e-5, f"rot_pred not orthonormal ({ortho})")
    check(bool((torch.linalg.det(rot) > 0).all()), "rot_pred det < 0")
    with plain_versions():
        ev_plain = Evaluator(model, model_points, template_bank=bank)
        pout = ev_plain._run(tb)
    e_rot = max_err(rot, pout["rot_pred"])
    e_trans = max_err(trans, pout["trans_pred"])
    print(f"kernel path vs plain versions on the card, one batch: rot_pred {e_rot:.3g} "
          f"trans_pred {e_trans:.3g} adds {max_err(out['adds'], pout['adds']):.3g}",
          flush=True)
    check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL,
          "kernel path disagrees with the plain versions")

    # ---- 4b. the fused path's eval, the same weights and batches ----------------
    Evaluator(model_f, model_points, template_bank=bank).evaluate(batches[:1])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ev_f = Evaluator(model_f, model_points, template_bank=bank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_f = ev_f.evaluate(batches)
    torch.cuda.synchronize()
    t_eval_f = time.perf_counter() - t0
    launches = read_counts()
    print(f"fused eval path launches {launches} over {encodes} encodes", flush=True)
    expect_counts(launches, {"voxelize": 1, "compact": 4, "fused": 4}, encodes, "fused eval")
    entries["fused"]["eval_launches"] = launches["fused"]
    check(res_f["n_scored"] == rows - 1, f"fused n_scored {res_f['n_scored']}")
    check(res_f["n_overflow"] == res["n_overflow"], "fused n_overflow differs")
    check(bool(np.isfinite(res_f["auc_mean"])), "fused auc_mean is not finite")
    out_f = ev_f._run(tb)
    with plain_versions():
        pout_f = Evaluator(model_f, model_points, template_bank=bank)._run(tb)
    for what, ref in (("the two-stage path", out), ("the plain versions", pout_f)):
        e_rot = max_err(out_f["rot_pred"], ref["rot_pred"])
        e_trans = max_err(out_f["trans_pred"], ref["trans_pred"])
        print(f"fused path vs {what}, one batch: rot_pred {e_rot:.3g} trans_pred "
              f"{e_trans:.3g}", flush=True)
        check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL, f"fused path disagrees with {what}")
    print(f"fused eval path on {card}: evaluate {t_eval_f:.3f} s for {rows} rows = "
          f"{rows / t_eval_f:.1f} instances/s (two-stage in this run {inst_s:.1f})",
          flush=True)

    # ---- 5. training path at full width -----------------------------------------
    del ev, ev_plain, out, pout, ev_f, out_f, pout_f, pyramid, grid, pgrid
    torch.cuda.empty_cache()
    train_launches, solver, train_batch, rate_two = train_phase(cfg, card)
    for key, n in train_launches.items():
        entries[key]["launches"] = n

    # ---- 6. one train step: kernel path vs plain path ---------------------------
    train_step_vs_plain(solver, train_batch, TWO_STAGE_TRAIN)
    del solver, train_batch
    torch.cuda.empty_cache()

    # ---- 7. the fused path's training, and one step against the two-stage path -
    f_launches, f_solver, f_batch, rate_fused = train_phase(
        cfg, card, "pallas_fused", FUSED_TRAIN_STEPS, FUSED_TRAIN)
    entries["fused"]["launches"] = f_launches["fused"]
    entries["fused_bwd"]["launches"] = f_launches["fused_bwd"]
    print(f"training on {card}: fused {rate_fused:.2f} samples/s, two-stage "
          f"{rate_two:.2f} samples/s", flush=True)
    train_step_vs_plain(f_solver, f_batch, FUSED_TRAIN, two_stage=DCLNet.from_config(
        mcfg, seed=0, interp_mode="pallas"))
    del f_solver, f_batch
    torch.cuda.empty_cache()

    # ---- 8a. stage-2 eval at full width on the fused stage 1 --------------------
    refiner = Refiner(n_inp=n_points, seed=0)
    Stage2Evaluator(model_f, refiner, model_points, iterations=ITERATIONS,
                    template_bank=bank).evaluate(batches[:1])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ev2 = Stage2Evaluator(model_f, refiner, model_points, iterations=ITERATIONS,
                          template_bank=bank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = ev2.evaluate(batches)
    torch.cuda.synchronize()
    t_eval2 = time.perf_counter() - t0
    launches = read_counts()
    print(f"stage-2 eval launches {launches} over {encodes} encodes", flush=True)
    expect_counts(launches, {"voxelize": 1, "compact": 4, "fused": 4}, encodes,
                  "stage-2 eval")
    check(res2["n_scored"] == rows - 1, f"stage-2 n_scored {res2['n_scored']}")
    check(bool(np.isfinite(res2["auc_mean"])), "stage-2 auc_mean is not finite")
    out2 = ev2._run(tb)
    rot2, trans2 = out2["rot_pred"], out2["trans_pred"]
    check(bool(torch.isfinite(rot2).all() and torch.isfinite(trans2).all()
               and torch.isfinite(out2["adds"]).all()), "stage-2 non-finite outputs")
    check(tuple(rot2.shape) == (BATCH, 3, 3) and tuple(trans2.shape) == (BATCH, 3),
          "stage-2 output shapes")
    ortho = max_err(rot2.transpose(1, 2) @ rot2, eye.expand_as(rot2))
    check(ortho < 1e-5, f"refined rot not orthonormal ({ortho})")
    check(bool((torch.linalg.det(rot2) > 0).all()), "refined rot det < 0")
    with plain_versions():
        pout2 = Stage2Evaluator(model_f, refiner, model_points, iterations=ITERATIONS,
                                template_bank=bank)._run(tb)
    e_rot = max_err(rot2, pout2["rot_pred"])
    e_trans = max_err(trans2, pout2["trans_pred"])
    print(f"stage-2 kernel path vs plain versions, one batch: rot {e_rot:.3g} trans "
          f"{e_trans:.3g}", flush=True)
    check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL,
          "stage-2 kernel path disagrees with the plain versions")
    print(f"stage-2 eval on {card}: {ITERATIONS} refinement steps, auc_mean "
          f"{res2['auc_mean']} n_scored {res2['n_scored']}, evaluate {t_eval2:.3f} s for "
          f"{rows} rows = {rows / t_eval2:.1f} instances/s", flush=True)
    del ev2, out2, pout2
    torch.cuda.empty_cache()

    # ---- 8b. stage-2 training at full width ---------------------------------------
    stage2_train_phase(card, model_f, model_points, grid_shape, n_points)

    # ---- 9. the YCB-V eval CLIs at full width, from PNG files on disk ------------
    torch.cuda.empty_cache()
    ycbv_cli_phase(card, model, n_points, entries)

    # ---- 10. the LineMOD family and reference weights ---------------------------
    torch.cuda.empty_cache()
    lm_phase(card, entries)

    # ---- 11. result lines -----------------------------------------------------
    print(json.dumps({"kernels": [entries[k] for k in KERNEL_ORDER]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
