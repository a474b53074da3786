#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage-1 and stage-2 inference, training and serving on
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
 3b. the bf16 variants of K1, K2, K3 and K6 (model.compute_dtype:
    bfloat16) against their bf16 plain versions on the card, K1 on the
    main-path batch and K2, K3, K6 at the four levels of the bf16
    backbone's pyramid of it: K1 counts equal and grid within BF16_ULPS,
    K2 bit-equal, K3 and K6 idx and w equal to the f32 kernel's and out
    within BF16_ULPS, K6 torch.equal to K2 -> centers -> K3 in bf16; each
    at batch 512 too, timed as the f32 kernels are;
 3c. the bf16 variants of K4, K5 and K7 (bf16 training) against their
    bf16 plain versions at the four levels of that pyramid, on K2's bf16
    output and K3's and K6's w and idx: K4 and K7 bit-equal (0 ulp) to their
    plain versions run on CPU copies and from launch to launch, also on the
    adversarial cotangents and indices of phase 3, and equal to the f32
    kernel on the widened cotangent rounded once; K5 bit-equal; each timed
    with its plain version and library call (index_add_ in f32 then
    rounded, index_copy_ of the bf16 rows);
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
    on the device preprocessing path (--override
    hyper_dataset_test.device_preprocess=True: raw candidates, the numpy
    tail on the card) at 512 with the config's loader threads: instances/s,
    the wait on the loader beside the numpy path's, n_overflow;
    then in bf16 (--override model.compute_dtype=bfloat16) at 512: rate,
    the model's seconds, peak memory, n_overflow; then
    tools/test_ycbv_stage2.main with a refiner checkpoint. Each run's
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
    torch.equal); test_lm in bf16 at 512 (rate, peak memory, n_overflow);
    then tools/train_stage1.main on the LineMOD tree, one
    epoch of 3 steps at batch 32. Each run's scored, lost and counted rows,
    results file and launch counts are checked, and the training's losses,
    changed parameters and launches (K1 2, K2-K5 8 a step);
11. bf16 eval at full width, the same seeded weights: Evaluator on the
    two-stage and the fused path with cuDNN's autotuning off and on (the
    f32 rates of phase 4 beside), launch counts (bf16 kernels only), one
    batch against the plain versions on the card (BF16_POSE_DEG,
    BF16_POSE_MM), the bf16-vs-f32 pose drift over every scored row (max,
    95th percentile, the JAX bound beside), one batch's device time by stage
    in f32 and bf16, and Stage2Evaluator on the fused bf16 stage 1;
12. bf16 training at full width (model.compute_dtype: bfloat16), the same
    seeded weights: Solver on the two-stage and the fused path, a warm-up
    and BF16_TRAIN_STEPS timed steps each (launches K1, K2 bf16 2 and 8,
    K3, K4, K5 bf16 8 a step, or K6, K7 bf16 8 a step, and no f32 kernel),
    finite losses, no skipped step, every parameter and BN statistic
    changed, samples/s, T_step and peak memory beside phase 5's and 7's f32
    ones; one step through the kernels torch.equal to itself and to the
    plain versions with K4's, K5's and K7's run on CPU copies, and within
    BF16_TRAIN_GRAD_REL_L2 of the plain versions run on the card; then
    BF16_STAGE2_TRAIN_STEPS refiner steps on the frozen fused bf16 stage 1;
13. the throughput training path: (a) one train-mode forward and
    backward at batch 32 without and with model.remat (losses and BN
    running statistics torch.equal, gradient within TRAIN_GRAD_REL_L2,
    the same launches, peak memory of each); (e) preprocess_core on the
    card against its CPU run on a raw batch of 128 x 8192 candidates from
    a YCB-V tree, the draws injected (PREPROCESS_ATOL; voxel ids within one
    on voxel boundaries, equal elsewhere), and DevicePreprocessor's time a
    batch; (b) configs/config_YCBV_bs128_throughput.yaml as written through
    tools/train_stage1.main on that tree (device preprocessing, 2 draws a
    frame, 10 process workers, the template bank; a train list of 256
    frames: a warm-up and THROUGHPUT_TIMED_STEPS timed steps), then the
    same config on the numpy path (device_preprocess False,
    samples_per_frame 1, thread workers; 512 frames); (c)
    configs/config_YCBV_bs256_peak.yaml with PEAK_OVERRIDES (768 frames: a
    warm-up and PEAK_TIMED_STEPS timed steps). Each training run: finite
    losses, no skipped step, the launches of the two-stage path, and
    samples/s, T_step, the wait on the loader, the device idle share
    (torch.profiler, kernels only) and peak memory; then no process this
    script started may still run (the process workers' forkserver and
    multiprocessing's resource tracker are stopped and waited for);
14. serving (dcl_net_tpu_torch/serving.py, the kernels reached through the
    dclx custom ops of ops/library.py): torch.library.opcheck of each op on
    the card in f32 and bf16, and the host time of a call through each op
    against its launch function; a two-stage f32 bundle of the phase-4 model
    (fixed batches 1, 16, 64, 512 and the batch-polymorphic artifact, one
    template encode) exported, saved and loaded in a fresh BundleServer,
    requests of 1, 5, 32, 100, 512 and 700 rows (700: two chunks) served,
    each row's pose within POSE_ATOL of Evaluator's and its overflow equal,
    each chunk launching K1 1, K2 4, K3 4 (no template encode); the poly
    artifact at 3 and 40 rows; a child process that imports only
    dcl_net_tpu_torch.serving, loads the bundle from disk and serves 5
    rows torch.equal to this process's; a fused stage-2 artifact (K1, K2,
    K6) against Stage2Evaluator and a bf16 artifact at batch 32 (bf16
    kernels only) against the bf16 Evaluator (BF16_POSE_DEG, BF16_POSE_MM);
    each artifact's export seconds and bytes, and served instances/s at 32
    and 512 beside the eager serving module's and phase 4's Evaluator's;
15. data parallelism (dcl_net_tpu_torch/parallel/mesh.py) at full width,
    global batch 8, cuDNN autotuning off: (a) the port's init_distributed
    with NCCL at world 1 on a file:// store, 3 stage-1 steps in lockstep
    with the same steps without a group, each from the same state: losses
    and BN statistics torch.equal, no collective issued, the gradient
    within TRAIN_GRAD_REL_L2 (the backward is not bit-reproducible on the
    card: avg_pool3d's CUDA backward adds with atomics; deterministic
    cuDNN); (b) two spawned ranks on the one card
    with backend gloo (a test arrangement: NCCL refuses two ranks on one
    GPU; the CLIs run one rank a GPU), 3 steps on the two-stage and on the
    fused path against one process on the same 8 rows: step-1 losses within
    TRAIN_LOSS_RTOL, the flat gradient within TRAIN_GRAD_REL_L2, later
    losses within PARALLEL_LATER_RTOL, the ranks' parameters equal after
    every step, and a stage-2 refiner step's losses within TRAIN_LOSS_RTOL;
    (c) Evaluator over the two ranks on two global batches of 32, its
    summary equal to one process's; (d) the seconds of each, the 2-rank and
    1-rank step times, one all-reduce of the 33.6 MB flat gradient under
    NCCL (world 1) and gloo (world 2, CUDA tensors); the launches of the
    phase's data-parallel runs go into the kernel line (parallel_launches).
    A rank that raises ends the other and fails the phase.
    `python3 chip_smoke.py --phase 15` runs phases 1, 2 and 15 alone;
16. the rest of the JAX package, at full width (config_YCBV_bs32.yaml's
    model, seed 0, phase 4's batches and bank), cuDNN autotuning off:
    (a) Evaluator on interp_mode "local" in f32 and bf16 (one K1 an encode,
    no K2, K3 or K6; finite poses; instances/s and peak memory beside the
    exact path's in the same run), each level's local features against the
    exact path's (K2 + K3) within LOCAL_ATOL on the points whose exact 3
    neighbours lie in the window (their share printed), 2 rows against the
    same model on the CPU within POSE_ATOL, then 2 train steps of a local
    Solver (finite, parameters and BN statistics changed); (b)
    voxelization modes 0-2 at the main batch: K1's sum torch.equal to the
    CPU's mode 0, modes 1-2 (ops/voxelize.py::voxelize_dense, no kernel)
    torch.equal to their CPU runs, one forward of a model of each mode
    (mode 0 runs K1 at mode 3: its poses torch.equal to mode 3's); (c) the
    data-parallel serving artifact at batch 32: one exported on the CPU and
    served on the card through ShardedServe by an NCCL group of one rank
    (its weights on the card, K1 1, K2 4, K3 4), and one served by two
    spawned gloo ranks sharing the card, each serving the global batch,
    all within SHARDED_ATOL of the single artifact (NCCL across GPUs:
    scripts/serve_sharded_multi_gpu.py); (d) the
    library surface against CPU copies: FPS of 16384 -> 1024 points, ball
    query, grouping, an SA-MSG and an FP module, the sparse max pool forward
    and gradient on a 64^3 grid at batch 2, the transposed and inverse
    convs, the field max pool; (e) K1's backward (the autograd formula of
    dclx::voxelize) at the main batch, modes 3 and 4, with and without a
    point mask, f32 and bf16 grids: one K1 launch a forward, the gradient
    torch.equal to the same op's on CPU copies of K1GRAD_CPU_ROWS rows, and
    to the plain version's autograd gradient on the card (in bf16, that
    gradient rounded to bf16, as the plain version's bf16 cast of the
    features rounds it). K1's launches of (a) and (b) go into its
    entries (local_eval_launches, local_train_launches, mode0_launches,
    and launches). `python3 chip_smoke.py --phase 16` runs phases 1, 2 and
    16 alone;
17. the last departures from the JAX package, cuDNN autotuning off: (a)
    K1 at N = 8192 and 16384, C = 7, through its rounds kernel (a hot cell
    of 5000 points spread over the point order, a hot last cell, points
    outside the grid), modes 3 and 4, with and without a point mask, f32
    and bf16 grids, torch.equal to the plain version; (b) K4 and K7 at N =
    4096 and 8192, C = 256 and 512 (cap 1024, a 16^3 grid), f32 and bf16
    cotangents, bit-equal to their plain versions on CPU copies and launch
    to launch, their chunked inverse index bit-equal to its plain version;
    each timed on the device at its new shapes beside its byte bound, the
    bf16 variants at the largest (large_n in the kernel line); (c) the model at n_inp = n_tmp = 4096: a
    two-stage and a fused train pass at batch 8, the launches of one pass,
    losses within TRAIN_LOSS_RTOL of the same pass on a CPU copy, then
    Evaluator at n_inp 8192 on 2 rows, poses within POSE_ATOL of the CPU
    (launches as large_n_launches); (d) Evaluator pipelined against strict
    order on 4 batches of 32, f32 and bf16: per-row distances and summary
    equal, batch i + 1 dispatched before batch i is fetched, one host sync
    in a dispatch, the eval backbone's read of its rulebook's sizes
    (torch.cuda.set_sync_debug_mode("warn"), counted), two Memcpy DtoH a
    batch, that read and the rows (torch.profiler), instances/s of both
    printed with no claim; (e) a 6-step Solver epoch at batch 4 with profile_dir, whose
    trace of steps 2-4 holds CUDA kernels of K1-K5. `python3 chip_smoke.py
    --phase 17` runs phases 1, 2 and 17 alone;
18. prints the per-kernel JSON line (the f32 kernels and the bf16
    variants), then the result line {"ok": true, "device": {...}} last.
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
BF16_TRAIN_STEPS = 3  # timed bf16 training steps after one warm-up step, each path
BF16_STAGE2_TRAIN_STEPS = 2  # refiner steps on the frozen bf16 stage 1
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
# The bf16 variants (K1, K3, K6) take f32 sums and round them to bf16 once,
# as their plain versions do; a sum taken in another order may round the
# other way: within one bf16 ulp. K2 copies rows: bit-equal.
BF16_ULPS = 1
# A bf16 path through the kernels against the same path through the plain
# versions on the card: each kernel is within one bf16 ulp of its plain
# version, and one ulp of a bf16 feature can move a rounding downstream
# (the 9D head's output is bf16, 0.4 % a step); held to the JAX package's
# bf16 drift bound (tests/test_model.py), as the port's bf16 is held to JAX's.
BF16_POSE_DEG, BF16_POSE_MM = 1.0, 0.5
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
# One bf16 train step, kernel path vs plain path. The bf16 kernels are
# bit-equal to their plain versions, K4 and K7 to theirs run on CPU copies
# (the f32 sums in entry order) and the bf16 step through the kernels is the
# same from pass to pass on an H100, so with the backward kernels' plain
# versions run on CPU copies the two paths give torch.equal losses and
# gradients. Run on the card, those plain versions' index_add_ adds in a
# run-dependent order, which flips a few bf16 roundings of the rows and,
# through the bf16 backward, moved the gradient by 1.36e-3 to 1.64e-3 in
# relative L2 on an NVIDIA H100 80GB HBM3 (losses equal): held within
# BF16_TRAIN_GRAD_REL_L2.
BF16_TRAIN_GRAD_REL_L2 = 2e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def child_processes() -> list:
    """(pid, command line) of every live process whose parent is this one."""
    import os

    me, out = os.getpid(), []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
            cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # it has exited meanwhile
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append((int(d.name), cmd.strip()[:120]))
    return out


def stop_child_processes() -> None:
    """Stop what the process workers leave behind and fail if any process
    this script started is still alive. The loaders stop the forkserver
    when their last pool closes; multiprocessing's resource tracker would
    exit only after this process has, so it is stopped here, once the
    pools' semaphores are collected (their finalizers would start it again)."""
    import gc
    from multiprocessing import resource_tracker

    gc.collect()
    resource_tracker._resource_tracker._stop()
    left = child_processes()
    check(not left, f"processes this script started are still running: {left}")
    print("child processes: none left running", flush=True)


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


def bf16_ulps(a, b) -> int:
    """The largest distance in bf16 ulps between two bf16 tensors (+0 and -0
    are one value)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def bf16_kernel_phase(entries: dict, card: str, feats, vidx, model_b, grid_shape) -> None:
    """The bf16 variants of K1, K2, K3 and K6 (model.compute_dtype:
    bfloat16) against their bf16 plain versions on the card, at the main
    path's shapes: K1 on the main-path batch (modes 3 and 4), K2, K3 and K6
    at the four levels of the bf16 backbone's pyramid of that batch
    (model_b, the seeded weights in bf16). K1: counts equal, grid within
    BF16_ULPS; K2 bit-equal; K3 and K6: idx and w torch.equal to the f32
    kernel's on the same rows taken to f32, out within BF16_ULPS of the
    plain version; K6 torch.equal to K2 -> centers -> K3 in bf16. Then each
    at the configs' eval batch of 512 (the batch-32 inputs repeated REPEAT
    times, each output torch.equal to the batch-32 output repeated). Times
    each as called and on the device (CUDA graph), its plain version and,
    for K1, its library yardstick; bounds with bf16 rows at 2 bytes. Writes
    the entries voxelize_bf16, compact_bf16, interp_bf16, fused_bf16."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp, cuda_voxelize
    from dcl_net_tpu_torch.ops.sparse_conv import voxel_centers

    bf16 = torch.bfloat16
    dev = feats.device
    t_phase = time.perf_counter()

    def rep(t):
        return t.repeat(REPEAT, *([1] * (t.dim() - 1)))

    # ---- K1
    b_, n_, c_ = feats.shape
    g_ = grid_shape[0] * grid_shape[1] * grid_shape[2]
    for mode in (3, 4):
        grid, count = cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, mode, out_dtype=bf16)
        pgrid, pcount = cuda_voxelize.voxelize_reference(feats, vidx, grid_shape, mode,
                                                         out_dtype=bf16)
        u1 = bf16_ulps(grid, pgrid)
        check(grid.dtype == bf16 and torch.equal(count, pcount) and u1 <= BF16_ULPS,
              f"K1 bf16 mode {mode}: counts differ or the grid is {u1} ulps off")
    e1, same1 = max_err(grid, pgrid), torch.equal(grid, pgrid)
    lin = (((vidx[..., 0].long() * grid_shape[1] + vidx[..., 1]) * grid_shape[2]
            + vidx[..., 2]) + torch.arange(b_, device=dev)[:, None] * g_).reshape(-1)
    ext = torch.cat([feats.to(bf16).float(), torch.ones_like(feats[..., :1])],
                    -1).reshape(-1, c_ + 1)

    def lib_mean():  # index_add_ of the bf16 payloads, the bf16 sum, the bf16 mean
        acc = torch.zeros(b_ * g_, c_ + 1, device=dev).index_add_(0, lin, ext)
        return (acc[:, :c_].to(bf16).float() / torch.clamp(acc[:, c_:], min=1.0)).to(bf16)

    u_lib = bf16_ulps(lib_mean(), pgrid.reshape(-1, c_))
    check(u_lib <= BF16_ULPS, f"K1 bf16 yardstick differs by {u_lib} ulps")
    args1 = (feats, vidx, grid_shape, 4)
    k1 = dict(ms=cuda_ms(lambda: cuda_voxelize.voxelize_cuda(*args1, out_dtype=bf16)),
              dev=graph_ms(lambda: cuda_voxelize.voxelize_cuda(*args1, out_dtype=bf16)),
              plain=cuda_ms(lambda: cuda_voxelize.voxelize_reference(*args1, out_dtype=bf16),
                            reps=5, warmup=1),
              lib=cuda_ms(lib_mean), lib_dev=graph_ms(lib_mean))
    f16, v16 = rep(feats), rep(vidx)
    big = cuda_voxelize.voxelize_cuda(f16, v16, grid_shape, 4, out_dtype=bf16)
    check(torch.equal(big[0], rep(grid)) and torch.equal(big[1], rep(count)),
          f"K1 bf16 at batch {BATCH * REPEAT}: not the batch-{BATCH} output repeated")
    del big
    k1.update(ms512=cuda_ms(lambda: cuda_voxelize.voxelize_cuda(f16, v16, grid_shape, 4,
                                                                 out_dtype=bf16), reps=5),
              dev512=graph_ms(lambda: cuda_voxelize.voxelize_cuda(f16, v16, grid_shape, 4,
                                                                   out_dtype=bf16),
                              calls=2, reps=3))
    del f16, v16
    torch.cuda.empty_cache()
    nbytes = b_ * n_ * (c_ + 3) * 4 + b_ * g_ * c_ * 2 + b_ * g_ * 4
    flops = b_ * n_ * (c_ + 1) + int((count > 1).sum()) * c_
    bms, bby = bound(nbytes, flops)
    entries["voxelize_bf16"] = dict(
        name="voxelize_bf16", route="cuda", source="dcl_net_tpu_torch/csrc/voxelize.cu",
        replaces="dcl_net_tpu/ops/pallas_voxelize.py:76", max_abs_err=e1, max_ulps=u1,
        bit_equal=same1, ms=k1["ms"], kernel_ms=k1["ms"], device_ms=k1["dev"],
        plain_ms=k1["plain"], bound_ms=bms, bound_by=bby, library_ms=k1["lib"],
        library_device_ms=k1["lib_dev"],
        library_call="index_add_ of the bf16-rounded features, bf16 sum over clamp(count, 1)",
        batch512_ms=k1["ms512"], batch512_device_ms=k1["dev512"])
    print(f"K1 bf16 voxelize [{b_},{n_},{c_}] -> {grid_shape} bf16: counts equal, grid within "
          f"{u1} ulp (bit-equal {same1}) of the plain version; kernel {k1['ms']:.4f} ms "
          f"(device {k1['dev']:.4f}), plain {k1['plain']:.4f} ms, index_add_ yardstick "
          f"{k1['lib']:.4f} ms (device {k1['lib_dev']:.4f}), bound {bms:.4f} ms ({bby}); at "
          f"batch {BATCH * REPEAT} {k1['ms512']:.4f} ms (device {k1['dev512']:.4f})", flush=True)

    # ---- K2, K3, K6 at the levels of the bf16 pyramid
    mask = (count > 0).to(torch.float32)
    with torch.inference_mode():
        pyramid = model_b.backbone_inp(grid, mask)
    del grid, pgrid
    pf = model_b.point_feats_inp
    points = feats[..., 4:7].contiguous()
    acc = {k: dict(err=0.0, ulps=0, ms=0.0, dev=0.0, plain=0.0, bytes=0.0, flops=0.0,
                   levels=[], ms512=0.0, dev512=0.0) for k in ("compact", "interp", "fused")}
    for level, (lf, lm) in enumerate(pyramid):
        lf, lm = lf.contiguous(), lm.contiguous()
        check(lf.dtype == bf16 and lm.dtype == torch.float32,
              f"bf16 pyramid level {level}: {lf.dtype} features, {lm.dtype} mask")
        b_, d0, d1, d2, c_ = lf.shape
        g_ = d0 * d1 * d2
        cap = min(pf.capacities[level], g_)
        affine = pf.center_affine[level]
        got2 = cuda_compact.dense_to_sparse_cuda(lf, lm, cap)
        for a, r, what in zip(got2, cuda_compact.dense_to_sparse_reference(lf, lm, cap),
                              ("coords", "vfeats", "vmask", "occupancy")):
            check(torch.equal(a, r), f"K2 bf16 level {level}: {what} not bit-equal to the "
                  "plain version")
        coords, vfeats, vmask, occ = got2
        check(vfeats.dtype == bf16 and vmask.dtype == torch.float32, "K2 bf16 output types")
        centers = voxel_centers(coords, pf.unit, pf.scale_list[level], pf.offset)
        args3 = (points, centers, vfeats, vmask, occ)
        out, w, idx = got3 = cuda_interp.nn_interpolate_cuda(*args3)
        _, w32, idx32 = cuda_interp.nn_interpolate_cuda(points, centers, vfeats.float(),
                                                        vmask, occ)
        check(out.dtype == bf16 and torch.equal(idx, idx32) and torch.equal(w, w32),
              f"K3 bf16 level {level}: idx or w differ from the f32 kernel's")
        pout = cuda_interp.nn_interpolate_reference(*args3)[0]
        u3 = bf16_ulps(out, pout)
        check(u3 <= BF16_ULPS, f"K3 bf16 level {level}: out {u3} ulps from the plain version")
        args6 = (points, coords, vfeats, vmask, occ, *affine)
        got6 = cuda_fused.compact_interpolate_cuda(*args6)
        for a, r, what in zip(got6, got3, ("out", "w", "idx")):
            check(torch.equal(a, r), f"K6 bf16 level {level}: {what} not torch.equal to K2 -> "
                  "centers -> K3 in bf16")
        u6 = bf16_ulps(got6[0], cuda_fused.compact_interpolate_reference(*args6)[0])
        check(u6 <= BF16_ULPS, f"K6 bf16 level {level}: out {u6} ulps from the plain version")
        acc["compact"]["err"] = 0.0
        acc["interp"]["err"] = max(acc["interp"]["err"], max_err(out, pout))
        acc["interp"]["ulps"] = max(acc["interp"]["ulps"], u3)
        acc["fused"]["err"] = acc["interp"]["err"]
        acc["fused"]["ulps"] = max(acc["fused"]["ulps"], u6)
        sel = torch.clamp(occ, max=cap).sum().item()  # the valid rows read
        n_ = points.shape[1]
        fns = {"compact": (lambda: cuda_compact.dense_to_sparse_cuda(lf, lm, cap),
                           lambda: cuda_compact.dense_to_sparse_reference(lf, lm, cap)),
               "interp": (lambda: cuda_interp.nn_interpolate_cuda(*args3),
                          lambda: cuda_interp.nn_interpolate_reference(*args3)),
               "fused": (lambda: cuda_fused.compact_interpolate_cuda(*args6),
                         lambda: cuda_fused.compact_interpolate_reference(*args6))}
        for key, (kernel, plain) in fns.items():
            d = graph_ms(kernel)
            acc[key]["ms"] += cuda_ms(kernel)
            acc[key]["dev"] += d
            acc[key]["levels"].append(d)
            acc[key]["plain"] += cuda_ms(plain, reps=5, warmup=1)
        # bytes: bf16 rows at 2 bytes; masks, coords, centers, points, w, idx at 4
        acc["compact"]["bytes"] += b_ * g_ * 4 + sel * c_ * 2 + b_ * cap * (c_ * 2 + 16) + b_ * 4
        for key in ("interp", "fused"):
            acc[key]["bytes"] += (b_ * n_ * 3 * 4 + sel * (16 + c_ * 2) + b_ * 4
                                  + b_ * n_ * c_ * 2 + 2 * b_ * 3 * n_ * 4)
            acc[key]["flops"] += 8 * n_ * sel + 5 * b_ * n_ * c_
        acc["fused"]["flops"] += 6 * sel
        # at the eval batch of 512: the level's inputs repeated
        lf16, lm16 = rep(lf), rep(lm)
        big2 = cuda_compact.dense_to_sparse_cuda(lf16, lm16, cap)
        for a, r, what in zip(big2, got2, ("coords", "vfeats", "vmask", "occupancy")):
            check(torch.equal(a, rep(r)), f"K2 bf16 level {level} at batch "
                  f"{BATCH * REPEAT}: {what} is not the batch-{BATCH} output repeated")
        a16 = (rep(points), voxel_centers(big2[0], pf.unit, pf.scale_list[level], pf.offset),
               big2[1], big2[2], big2[3])
        a6 = (a16[0], *big2, *affine)
        for key, fn, want in (("interp", lambda: cuda_interp.nn_interpolate_cuda(*a16), got3),
                              ("fused", lambda: cuda_fused.compact_interpolate_cuda(*a6), got6)):
            for a, r, what in zip(fn(), want, ("out", "w", "idx")):
                check(torch.equal(a, rep(r)), f"{key} bf16 level {level} at batch "
                      f"{BATCH * REPEAT}: {what} is not the batch-{BATCH} output repeated")
        for key, fn in (("compact", lambda: cuda_compact.dense_to_sparse_cuda(lf16, lm16, cap)),
                        ("interp", lambda: cuda_interp.nn_interpolate_cuda(*a16)),
                        ("fused", lambda: cuda_fused.compact_interpolate_cuda(*a6))):
            acc[key]["ms512"] += cuda_ms(fn, reps=10)
            acc[key]["dev512"] += graph_ms(fn, calls=4, reps=5)
        del lf16, lm16, big2, a16, a6
        torch.cuda.empty_cache()
    csrc = "dcl_net_tpu_torch/csrc/"
    for key, src, repl in (("compact", "compact.cu", "dcl_net_tpu/ops/pallas_compact.py:79"),
                           ("interp", "interp.cu", "dcl_net_tpu/ops/pallas_interp.py:42"),
                           ("fused", "fused.cu", "dcl_net_tpu/ops/pallas_fused.py:45")):
        a = acc[key]
        bms, bby = bound(a["bytes"], a["flops"])
        entries[f"{key}_bf16"] = dict(
            name=f"{key}_bf16", route="cuda", source=csrc + src, replaces=repl,
            max_abs_err=a["err"], max_ulps=a["ulps"], ms=a["ms"], kernel_ms=a["ms"],
            device_ms=a["dev"], plain_ms=a["plain"], bound_ms=bms, bound_by=bby,
            library_ms=None, library_device_ms=None, level_device_ms=a["levels"],
            batch512_ms=a["ms512"], batch512_device_ms=a["dev512"])
        print(f"{key}_bf16 over the 4 levels of one branch on {card}: kernel {a['ms']:.4f} ms "
              f"(device {a['dev']:.4f}; per level "
              f"{', '.join(f'{t:.4f}' for t in a['levels'])}) plain {a['plain']:.4f} ms bound "
              f"{bms:.4f} ms ({bby}); max {a['ulps']} ulp from the plain version; at batch "
              f"{BATCH * REPEAT} {a['ms512']:.4f} ms (device {a['dev512']:.4f})", flush=True)
    print(f"bf16 kernels: K2 bit-equal, K3 and K6 idx and w equal to the f32 kernel's, K6 "
          f"torch.equal to K2 -> centers -> K3, at every level and at batch "
          f"{BATCH * REPEAT}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def bf16_bwd_kernel_phase(entries: dict, card: str, feats, vidx, model_b, grid_shape) -> None:
    """The bf16 variants of K4, K5 and K7 (bf16 training) against their bf16
    plain versions, at the four levels of the bf16 backbone's pyramid of the
    main-path batch (model_b, the seeded weights in bf16), with K2's bf16
    output and K3's and K6's w and idx there, and seeded bf16 cotangents.
    K4 and K7: bf16, bit-equal (0 ulp) to their plain versions run on CPU
    copies and from launch to launch, also on adversarial_bwd_inputs (one
    slot taking all 3N contributions of a sample, cotangents of mixed
    magnitude), equal to the f32 kernel on the widened cotangent rounded to
    bf16 once, and within INTERP_BWD_RTOL of sum |w g| of the plain versions
    run on the card (index_add_ there adds in another order), beyond what
    rounding each sum to bf16 adds; their inverse index bit-equal to its
    plain version. K5: bf16, bit-equal to its plain version on the
    card. Times each as called and on the device (CUDA graph), its plain
    version and the nearest library call after holding it to the plain
    version: K4 index_add_ in f32, then rounded to bf16; K5 index_copy_ of
    the bf16 rows; K7 index_add_ into the f32 grid, then rounded. Bounds
    with bf16 values at 2 bytes. Writes the entries interp_bwd_bf16,
    compact_bwd_bf16, fused_bwd_bf16."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp, cuda_voxelize
    from dcl_net_tpu_torch.ops.sparse_conv import voxel_centers

    bf16 = torch.bfloat16
    dev = feats.device
    gen = torch.Generator(device=dev).manual_seed(11)
    t_phase = time.perf_counter()
    grid, count = cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 4, out_dtype=bf16)
    with torch.inference_mode():
        pyramid = model_b.backbone_inp(grid, (count > 0).to(torch.float32))
    del grid
    pf = model_b.point_feats_inp
    points = feats[..., 4:7].contiguous()
    acc = {k: dict(ulps=0, ms=0.0, dev=0.0, plain=0.0, lib=0.0, lib_dev=0.0, bytes=0.0,
                   flops=0.0, levels=[], index_dev=0.0) for k in ("k4", "k5", "k7")}
    for level, (lf, lm) in enumerate(pyramid):
        lf, lm = lf.contiguous(), lm.contiguous()
        b_, d0, d1, d2, c_ = lf.shape
        g_ = d0 * d1 * d2
        grid3 = (d0, d1, d2)
        cap = min(pf.capacities[level], g_)
        coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(lf, lm, cap)
        centers = voxel_centers(coords, pf.unit, pf.scale_list[level], pf.offset)
        _, w, idx = cuda_interp.nn_interpolate_cuda(points, centers, vfeats, vmask, occ)
        _, w6, idx6 = cuda_fused.compact_interpolate_cuda(points, coords, vfeats, vmask, occ,
                                                          *pf.center_affine[level])
        n_ = points.shape[1]
        n_valid = int((vmask > 0).sum())

        def rand(*shape):
            return torch.randn(shape, device=dev, generator=gen).to(bf16)

        # K4 bf16
        g = rand(b_, n_, c_)
        gi_a, ii_a = adversarial_bwd_inputs(g.float(), idx, vmask, seed=20 + level)
        for gi, ii, what in ((g, idx, ""), (gi_a.to(bf16), ii_a, ", adversarial")):
            check_inverse_index(ii, cap, f"K4 bf16 level {level}{what}")
            got = bit_equal_on_cpu(cuda_interp.nn_interpolate_bwd_cuda,
                                   cuda_interp.nn_interpolate_bwd_reference, (gi, w, ii, cap),
                                   f"K4 bf16 level {level}{what}")
            check(got.dtype == bf16 and torch.equal(got, cuda_interp.nn_interpolate_bwd_cuda(
                gi.float(), w, ii, cap).to(bf16)), f"K4 bf16 level {level}{what}: not the f32 "
                "kernel on the widened cotangent rounded once")
        got4 = cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, cap)
        ref4 = cuda_interp.nn_interpolate_bwd_reference(g, w, idx, cap)
        mass = cuda_interp.nn_interpolate_bwd_reference(g.float().abs(), w.abs(), idx, cap)
        rows = (idx.long() + cap * torch.arange(b_, device=dev)[:, None, None]).reshape(-1)
        terms = (w[..., None] * g.float()[:, None]).reshape(-1, c_)

        def lib4():
            return torch.zeros(b_ * cap, c_, device=dev).index_add_(0, rows, terms).to(bf16)

        # the card's index_add_ sums in another order: its f32 sums within
        # INTERP_BWD_RTOL of sum |w g|, then each rounded to bf16
        rel, rel_l = (bf16_share_of_mass(a, ref4, mass)
                      for a in (got4, lib4().reshape(got4.shape)))
        check(rel <= INTERP_BWD_RTOL and rel_l <= INTERP_BWD_RTOL, f"K4 bf16 level {level}: "
              f"{rel:.3g} of sum |w g| from the plain version on the card, index_add_ "
              f"{rel_l:.3g}, past the bf16 rounding")
        a = acc["k4"]
        d = graph_ms(lambda: cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, cap))
        a["dev"] += d
        a["levels"].append(d)
        a["index_dev"] += graph_ms(lambda: cuda_interp.inverse_index_cuda(idx, cap))
        a["ms"] += cuda_ms(lambda: cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, cap))
        a["plain"] += cuda_ms(lambda: cuda_interp.nn_interpolate_bwd_reference(g, w, idx, cap))
        a["lib"] += cuda_ms(lib4)
        a["lib_dev"] += graph_ms(lib4)
        a["bytes"] += b_ * n_ * c_ * 2 + 2 * b_ * 3 * n_ * 4 + b_ * cap * c_ * 2
        a["flops"] += 6 * b_ * n_ * c_

        # K5 bf16
        dv = rand(b_, cap, c_)
        got5 = cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask, grid3)
        ref5 = cuda_compact.dense_to_sparse_bwd_reference(dv, coords, vmask, grid3)
        check(got5.dtype == bf16 and torch.equal(got5.view(torch.int16), ref5.view(torch.int16)),
              f"K5 bf16 level {level}: not bit-equal to the plain version")
        valid = vmask.reshape(-1) > 0
        lin = (((coords[..., 0].long() * d1 + coords[..., 1]) * d2 + coords[..., 2])
               + g_ * torch.arange(b_, device=dev)[:, None]).reshape(-1)[valid]
        vals = dv.reshape(-1, c_)[valid]

        def lib5():
            return torch.zeros(b_ * g_, c_, dtype=bf16, device=dev).index_copy_(0, lin, vals)

        check(torch.equal(lib5().reshape(got5.shape), got5),
              f"K5 bf16 level {level}: the index_copy_ call computes another function")
        a = acc["k5"]
        d = graph_ms(lambda: cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask, grid3))
        a["dev"] += d
        a["levels"].append(d)
        a["ms"] += cuda_ms(lambda: cuda_compact.dense_to_sparse_bwd_cuda(dv, coords, vmask,
                                                                         grid3))
        a["plain"] += cuda_ms(lambda: cuda_compact.dense_to_sparse_bwd_reference(
            dv, coords, vmask, grid3))
        a["lib"] += cuda_ms(lib5)
        a["lib_dev"] += graph_ms(lib5)
        a["bytes"] += n_valid * c_ * 2 + b_ * cap * 16 + b_ * g_ * c_ * 2

        # K7 bf16
        g7 = rand(b_, n_, c_)
        gi_a, ii_a = adversarial_bwd_inputs(g7.float(), idx6, vmask, seed=30 + level)
        for gi, ii, what in ((g7, idx6, ""), (gi_a.to(bf16), ii_a, ", adversarial")):
            check_inverse_index(ii, cap, f"K7 bf16 level {level}{what}")
            args7 = (gi, w6, ii, coords, vmask, grid3)
            got = bit_equal_on_cpu(cuda_fused.compact_interpolate_bwd_cuda,
                                   cuda_fused.compact_interpolate_bwd_reference, args7,
                                   f"K7 bf16 level {level}{what}")
            check(got.dtype == bf16 and torch.equal(got, cuda_fused.compact_interpolate_bwd_cuda(
                gi.float(), *args7[1:]).to(bf16)), f"K7 bf16 level {level}{what}: not the f32 "
                "kernel on the widened cotangent rounded once")
        args7 = (g7, w6, idx6, coords, vmask, grid3)
        got7 = cuda_fused.compact_interpolate_bwd_cuda(*args7)
        ref7 = cuda_fused.compact_interpolate_bwd_reference(*args7)
        mass7 = cuda_fused.compact_interpolate_bwd_reference(g7.float().abs(), w6.abs(),
                                                             *args7[2:])
        nb = idx6.long().reshape(b_, 3 * n_)
        cell = torch.gather(coords, 1, nb[..., None].expand(-1, -1, 3)).long()
        rows7 = (((cell[..., 0] * d1 + cell[..., 1]) * d2 + cell[..., 2])
                 + g_ * torch.arange(b_, device=dev)[:, None]).reshape(-1)
        terms7 = ((w6 * torch.gather(vmask, 1, nb).reshape(b_, 3, n_))[..., None]
                  * g7.float()[:, None]).reshape(-1, c_)

        def lib7():
            return torch.zeros(b_ * g_, c_, device=dev).index_add_(0, rows7, terms7).to(bf16)

        rel, rel_l = (bf16_share_of_mass(a, ref7, mass7)
                      for a in (got7, lib7().reshape(got7.shape)))
        check(rel <= INTERP_BWD_RTOL and rel_l <= INTERP_BWD_RTOL, f"K7 bf16 level {level}: "
              f"{rel:.3g} of sum |w g| from the plain version on the card, index_add_ "
              f"{rel_l:.3g}, past the bf16 rounding")
        a = acc["k7"]
        d = graph_ms(lambda: cuda_fused.compact_interpolate_bwd_cuda(*args7))
        a["dev"] += d
        a["levels"].append(d)
        a["index_dev"] += graph_ms(lambda: cuda_interp.inverse_index_cuda(idx6, cap))
        a["ms"] += cuda_ms(lambda: cuda_fused.compact_interpolate_bwd_cuda(*args7))
        a["plain"] += cuda_ms(lambda: cuda_fused.compact_interpolate_bwd_reference(*args7))
        a["lib"] += cuda_ms(lib7)
        a["lib_dev"] += graph_ms(lib7)
        a["bytes"] += (b_ * n_ * c_ * 2 + 2 * b_ * 3 * n_ * 4 + n_valid * 16
                       + b_ * g_ * c_ * 2)
        a["flops"] += 6 * b_ * n_ * c_
        print(f"bf16 backward level {level} [{b_},{n_},{c_}] cap {cap} -> {d0}^3: K4 and K7 "
              f"bit-equal to their plain versions on the CPU (and on the adversarial set), "
              f"K5 bit-equal; device ms K4 {acc['k4']['levels'][-1]:.4f} K5 "
              f"{acc['k5']['levels'][-1]:.4f} K7 {acc['k7']['levels'][-1]:.4f}", flush=True)
    del pyramid
    torch.cuda.empty_cache()
    csrc = "dcl_net_tpu_torch/csrc/"
    for key, name, src, repl, lib in (
            ("k4", "interp_bwd_bf16", "interp.cu", "dcl_net_tpu/ops/pallas_interp.py:167",
             "index_add_ of the f32 terms, then rounded to bf16"),
            ("k5", "compact_bwd_bf16", "compact.cu", "dcl_net_tpu/ops/pallas_compact.py:271",
             "index_copy_ of the bf16 rows into a bf16 grid"),
            ("k7", "fused_bwd_bf16", "fused.cu", "dcl_net_tpu/ops/pallas_fused.py:182",
             "index_add_ of the f32 terms into the grid, then rounded to bf16")):
        a = acc[key]
        bms, bby = bound(a["bytes"], a["flops"])
        entries[name] = dict(
            name=name, route="cuda", source=csrc + src, replaces=repl, max_abs_err=0.0,
            max_ulps=0, bit_equal=True, ms=a["ms"], kernel_ms=a["ms"], device_ms=a["dev"],
            plain_ms=a["plain"], bound_ms=bms, bound_by=bby, library_ms=a["lib"],
            library_device_ms=a["lib_dev"], library_call=lib, level_device_ms=a["levels"])
        if key != "k5":
            entries[name]["index_device_ms"] = a["index_dev"]
        print(f"{name} over the 4 levels of one branch on {card}: kernel {a['ms']:.4f} ms "
              f"(device {a['dev']:.4f}; per level {', '.join(f'{t:.4f}' for t in a['levels'])})"
              f" plain {a['plain']:.4f} ms library {a['lib']:.4f} ms (device "
              f"{a['lib_dev']:.4f}) bound {bms:.4f} ms ({bby}); 0 ulp from the plain version",
              flush=True)
    print(f"bf16 backward kernels: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def bf16_train_step_vs_plain(solver, batch, per_pass) -> None:
    """One bf16 train-mode forward and backward from the same state, through
    the kernels twice (the same losses and gradients), through the plain
    versions with K4's, K5's and K7's run on CPU copies (torch.equal losses
    and gradients: the bf16 kernels are bit-equal to them), and through the
    plain versions run on the card (within BF16_TRAIN_GRAD_REL_L2). The BN
    running statistics are put back after each pass."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp

    model = solver.model
    mode = model.point_feats_inp.interp_mode

    def on_cpu(plain):
        def run(*args):
            dev = next(a.device for a in args if torch.is_tensor(a))
            return plain(*(a.cpu() if torch.is_tensor(a) else a for a in args)).to(dev)
        return run

    reset_counts()
    lk, gk = train_pass(model, batch)
    expect_counts(read_counts(), per_pass, 1, f"one bf16 train pass ({mode})")
    lk2, gk2 = train_pass(model, batch)
    with plain_versions():
        lp, gp = train_pass(model, batch)
        cuda_interp.nn_interpolate_bwd_cuda = on_cpu(cuda_interp.nn_interpolate_bwd_reference)
        cuda_compact.dense_to_sparse_bwd_cuda = on_cpu(
            cuda_compact.dense_to_sparse_bwd_reference)
        cuda_fused.compact_interpolate_bwd_cuda = on_cpu(
            cuda_fused.compact_interpolate_bwd_reference)
        lc, gc = train_pass(model, batch)
    expect_counts(read_counts(), per_pass, 2, "the bf16 plain passes launched a kernel:")
    check(gk.dtype == torch.float32, f"bf16 step: {gk.dtype} parameter gradients")
    check(lk == lk2 and torch.equal(gk, gk2),
          f"bf16 train step ({mode}): two passes through the kernels differ")
    check(lk == lc and torch.equal(gk, gc), f"bf16 train step ({mode}): the kernel path is "
          f"not torch.equal to the plain path (backward plain versions on CPU copies): "
          f"gradient rel L2 {float((gk - gc).norm() / gc.norm()):.3g}")
    rel = float((gk - gp).norm()) / float(gp.norm())
    loss_rel = max(abs(lk[k] - lp[k]) / abs(lp[k]) for k in lp)
    print(f"bf16 train step ({mode}): kernel path torch.equal to itself and to the plain "
          f"path with the backward plain versions on CPU copies; vs the plain versions on "
          f"the card: losses rel {loss_rel:.3g}, gradient rel L2 {rel:.3g}", flush=True)
    check(rel <= BF16_TRAIN_GRAD_REL_L2 and loss_rel <= TRAIN_LOSS_RTOL,
          f"bf16 train step ({mode}): the plain versions on the card differ by {rel:.3g}")


def pose_drift(a, b, keep):
    """Per kept row of two evaluator outputs: the angle between their
    rotations in degrees and the distance between their translations in mm,
    in f64."""
    import numpy as np

    ra, rb = (x["rot_pred"][keep].double().cpu().numpy() for x in (a, b))
    ta, tb = (x["trans_pred"][keep].double().cpu().numpy() for x in (a, b))
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): exact for small angles, where
    # arccos of the trace loses them below about 0.03 degrees
    chord = np.linalg.norm(ra - rb, axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    return (np.degrees(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0))),
            np.linalg.norm(ta - tb, axis=1) * 1000.0)


def bf16_eval_phase(card: str, mcfg, batches, bank, model_points, rates: dict,
                    entries: dict) -> None:
    """Stage-1 eval in bf16 (model.compute_dtype: bfloat16) at full width,
    the seeded weights of the f32 phases: Evaluator on the two-stage and
    the fused path, each with cuDNN's autotuning off (the setting of the
    f32 eval of phase 4) and on, launch counts per encode (K1, K2 and K3 or
    K6 in bf16, no f32 kernel), one batch against the same bf16 path through
    the plain versions on the card (poses within BF16_POSE_DEG and
    BF16_POSE_MM); the bf16-vs-f32 pose drift over every scored row
    (max and 95th percentile, beside the JAX package's drift bound); the
    bf16 and f32 rates (rates: phase 4's f32 instances/s); one batch's
    device time by stage in f32 and bf16 (scripts/profile_torch_stage1.py's
    stage_breakdown); then Stage2Evaluator on the fused bf16 stage 1."""
    import importlib.util

    import numpy as np
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.eval.evaluator import Evaluator, Stage2Evaluator
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.models.refiner import Refiner

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    dev = torch.device("cuda")
    rows = BATCH * len(batches)
    encodes = 1 + len(batches)
    saved_benchmark = torch.backends.cudnn.benchmark
    tb = batch_to_torch(batches[1], dev)
    models = {"two-stage": DCLNet.from_config(mcfg, seed=0, dtype=bf16),
              "fused": DCLNet.from_config(mcfg, seed=0, dtype=bf16, interp_mode="pallas_fused")}
    kernels = {"two-stage": {"voxelize_bf16": 1, "compact_bf16": 4, "interp_bf16": 4},
               "fused": {"voxelize_bf16": 1, "compact_bf16": 4, "fused_bf16": 4}}
    evs = {}
    for path, model_b in models.items():
        for autotune in (False, True):
            torch.backends.cudnn.benchmark = autotune
            Evaluator(model_b, model_points, template_bank=bank).evaluate(batches[:1])
            torch.cuda.synchronize()
            reset_counts()
            ev = Evaluator(model_b, model_points, template_bank=bank)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ev.evaluate(batches)
            torch.cuda.synchronize()
            t_eval = time.perf_counter() - t0
            counts = read_counts()
            expect_counts(counts, kernels[path], encodes, f"bf16 {path} eval")
            check(res["n_scored"] == rows - 1 and bool(np.isfinite(res["auc_mean"])),
                  f"bf16 {path} eval: n_scored {res['n_scored']} auc {res['auc_mean']}")
            if not autotune:
                for key, n in counts.items():
                    if n:
                        entries[key]["launches"] = entries[key]["eval_launches"] = n
                evs[path] = ev
            print(f"bf16 {path} eval on {card}, cuDNN autotuning {autotune}: evaluate "
                  f"{t_eval:.3f} s for {rows} rows = {rows / t_eval:.1f} instances/s (f32 "
                  f"{path} in phase 4, autotuning off: {rates[path]:.1f}); auc_mean "
                  f"{res['auc_mean']} n_overflow {res['n_overflow']}; launches {counts}",
                  flush=True)
        torch.backends.cudnn.benchmark = False
        out = evs[path]._run(tb)
        rot = out["rot_pred"]
        check(rot.dtype == out["trans_pred"].dtype == torch.float32
              and bool(torch.isfinite(rot).all() and torch.isfinite(out["trans_pred"]).all()),
              f"bf16 {path}: poses not f32 or not finite")
        eye = torch.eye(3, device=dev)
        check(max_err(rot.transpose(1, 2) @ rot, eye.expand_as(rot)) < 1e-5,
              f"bf16 {path}: rot_pred not orthonormal")
        with plain_versions():
            pout = Evaluator(models[path], model_points, template_bank=bank)._run(tb)
        keep = (tb["valid"] > 0) & ~(tb["pad"] > 0)
        d_rot, d_trans = pose_drift(out, pout, keep)
        print(f"bf16 {path} kernel path vs the plain versions on the card, one batch: "
              f"rot {d_rot.max():.4g} deg, trans {d_trans.max():.4g} mm (bound "
              f"{BF16_POSE_DEG} deg, {BF16_POSE_MM} mm); poses torch.equal: "
              f"{torch.equal(out['rot_pred'], pout['rot_pred'])}", flush=True)
        check(d_rot.max() < BF16_POSE_DEG and d_trans.max() < BF16_POSE_MM,
              f"bf16 {path}: the kernel path disagrees with the plain versions")

    # the bf16-vs-f32 drift over every scored row, and one batch's stages
    model32 = DCLNet.from_config(mcfg, seed=0)
    ev32 = Evaluator(model32, model_points, template_bank=bank)
    rot_d, trans_d = [], []
    for batch in batches:
        b = batch_to_torch(batch, dev)
        keep = (b["valid"] > 0) & ~(b["pad"] > 0)
        r, t = pose_drift(ev32._run(b), evs["two-stage"]._run(b), keep)
        rot_d.append(r)
        trans_d.append(t)
    rot_d, trans_d = np.concatenate(rot_d), np.concatenate(trans_d)
    print(f"bf16 vs f32 pose drift over {rot_d.size} scored rows on {card} (same weights and "
          f"batches, two-stage): rotation max {rot_d.max():.4f} deg, p95 "
          f"{np.percentile(rot_d, 95):.4f} deg; translation max {trans_d.max():.4f} mm, p95 "
          f"{np.percentile(trans_d, 95):.4f} mm; the JAX package's bound 1 deg, 0.5 mm: "
          f"within {bool(rot_d.max() < 1.0 and trans_d.max() < 0.5)}", flush=True)
    spec = importlib.util.spec_from_file_location(
        "profile_torch_stage1", ROOT / "scripts" / "profile_torch_stage1.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    t32 = prof.stage_breakdown(model32, ev32, tb)
    t16 = prof.stage_breakdown(models["two-stage"], evs["two-stage"], tb)
    print(f"one batch of {BATCH} by stage on {card}, device ms (CUDA events, median of 10, "
          f"autotuning off), f32 / bf16: " + "; ".join(
              f"{s} {t32[s]:.3f} / {t16[s]:.3f}" for s in prof.STAGES)
          + f"; total {sum(t32.values()):.3f} / {sum(t16.values()):.3f}", flush=True)
    del ev32, model32, evs

    # stage 2 on the fused bf16 stage 1 (the refiner stays f32)
    refiner = Refiner(n_inp=int(mcfg.n_inp), seed=0)
    model_b = models["fused"]
    Stage2Evaluator(model_b, refiner, model_points, iterations=ITERATIONS,
                    template_bank=bank).evaluate(batches[:1])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ev2 = Stage2Evaluator(model_b, refiner, model_points, iterations=ITERATIONS,
                          template_bank=bank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = ev2.evaluate(batches)
    torch.cuda.synchronize()
    t_eval2 = time.perf_counter() - t0
    counts = read_counts()
    expect_counts(counts, kernels["fused"], encodes, "bf16 stage-2 eval")
    check(res2["n_scored"] == rows - 1 and bool(np.isfinite(res2["auc_mean"])),
          f"bf16 stage-2 eval: n_scored {res2['n_scored']}")
    out2 = ev2._run(tb)
    with plain_versions():
        pout2 = Stage2Evaluator(model_b, refiner, model_points, iterations=ITERATIONS,
                                template_bank=bank)._run(tb)
    keep = (tb["valid"] > 0) & ~(tb["pad"] > 0)
    d_rot, d_trans = pose_drift(out2, pout2, keep)
    check(out2["rot_pred"].dtype == torch.float32 and bool(torch.isfinite(out2["adds"]).all())
          and d_rot.max() < BF16_POSE_DEG and d_trans.max() < BF16_POSE_MM,
          "bf16 stage 2: poses not f32, not finite, or off the plain versions")
    print(f"bf16 stage-2 eval on {card}: {ITERATIONS} refinement steps on the fused bf16 stage "
          f"1, auc_mean {res2['auc_mean']} n_scored {res2['n_scored']}, evaluate "
          f"{t_eval2:.3f} s = {rows / t_eval2:.1f} instances/s; launches {counts}; vs the plain "
          f"versions, one batch: rot {d_rot.max():.4g} deg, trans {d_trans.max():.4g} mm",
          flush=True)
    torch.backends.cudnn.benchmark = saved_benchmark
    print(f"bf16 eval phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def bit_equal_on_cpu(kernel, plain, args, what: str):
    """kernel(*args) on the card twice: the two results equal bit for bit,
    and equal bit for bit (signs of zero included) to plain(*args) run on
    CPU copies of the inputs. Returns the first result."""
    import torch

    def bits(t):  # f32 or bf16 values as their bit patterns
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    got = kernel(*args)
    again = kernel(*args)
    check(torch.equal(bits(got), bits(again)), f"{what}: two launches on the same inputs differ")
    want = plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    check(got.dtype == want.dtype and torch.equal(bits(got.cpu()), bits(want)),
          f"{what}: not bit-equal to the plain version on the CPU "
          f"(max abs {max_err(got.cpu().float(), want.float()):.3g})")
    return got


def share_of_mass(got, ref, mass) -> float:
    """The largest |got - ref| per element, over sum |w g| of that element."""
    return float(((got - ref).abs() / mass.clamp(min=1e-30)).max())


def bf16_share_of_mass(got, ref, mass) -> float:
    """share_of_mass of two bf16 results of f32 sums, less what rounding
    each sum to bf16 once may add (half an ulp, at most 2^-8 of the value,
    for each side)."""
    got, ref = got.float(), ref.float()
    slack = 2.0 ** -8 * (got.abs() + ref.abs())
    return float(((got - ref).abs() - slack).clamp(min=0.0).div(mass.clamp(min=1e-30)).max())


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
    # the bf16 variants (model.compute_dtype: bfloat16)
    ("voxelize_bf16", "cuda_voxelize", "launches_bf16"),
    ("compact_bf16", "cuda_compact", "launches_bf16"),
    ("interp_bf16", "cuda_interp", "launches_bf16"),
    ("fused_bf16", "cuda_fused", "launches_bf16"),
    ("interp_bwd_bf16", "cuda_interp", "bwd_launches_bf16"),
    ("compact_bwd_bf16", "cuda_compact", "bwd_launches_bf16"),
    ("fused_bwd_bf16", "cuda_fused", "bwd_launches_bf16"),
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
TWO_STAGE_TRAIN_BF16 = {f"{k}_bf16": n for k, n in TWO_STAGE_TRAIN.items()}
FUSED_TRAIN_BF16 = {f"{k}_bf16": n for k, n in FUSED_TRAIN.items()}


def train_phase(cfg, card, interp_mode="pallas", steps=TRAIN_STEPS,
                per_step=TWO_STAGE_TRAIN, device="cuda"):
    """Solver at full width (in cfg.model's compute dtype): a warm-up step,
    then `steps` counted and timed steps through train_epoch. Returns
    (launch counts over the timed steps, the solver, one device batch of the
    run, {"rate": samples/s, "t_step": mean T_step s, "peak_gib": peak
    device memory})."""
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
    name = interp_mode if model.dtype is None else f"{interp_mode}, bf16"
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
    print(f"train ({name}) warm-up step {time.perf_counter() - t0:.3f} s, "
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
    print(f"train ({name}) path launches {launches} over {n} steps", flush=True)
    expect_counts(launches, per_step, n, f"train ({name})")
    for key in ("loss_all", "loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "grad_norm"):
        check(bool(np.isfinite(avg[key])), f"train {key} not finite: {avg[key]}")
    check(avg["skipped_nonfinite"] == 0.0, "a training step was skipped as non-finite")
    check(all(not torch.equal(a, p) for a, p in zip(params0, model.parameters())),
          "some parameter did not change")
    check(all(not torch.equal(a, b) for a, b in zip(stats0, bn_statistics(model))),
          "some BN running statistic did not change")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = n * bs / t_train
    print(f"train ({name}) path on {card}: {n} steps of batch {bs} in "
          f"{t_train:.3f} s = {rate:.2f} samples/s, T_step mean {avg['T_step']:.4f} s, "
          f"T_data mean {avg['T_data']:.4f} s, peak memory {peak:.2f} GiB; mean loss_all "
          f"{avg['loss_all']:.5f} grad_norm {avg['grad_norm']:.3f} "
          f"overflow_frac {avg['overflow_frac']:.4f}", flush=True)
    return launches, solver, first, dict(rate=rate, t_step=avg["T_step"], peak_gib=peak)


def train_pass(model, batch):
    """Losses and the flat parameter gradient of one train-mode forward and
    backward; the BN running statistics are put back after it."""
    import torch

    from dcl_net_tpu_torch.models.dcl_net import dcl_losses
    from dcl_net_tpu_torch.train.solver import bn_statistics

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


def train_step_vs_plain(solver, batch, per_pass, two_stage=None) -> None:
    """Losses and parameter gradients of one train-mode forward and backward
    from the same state, through the kernels and through the plain
    versions, and (two_stage: a two-stage model with the same state) on the
    two-stage path. per_pass: the launches of one kernel pass."""
    import torch

    model = solver.model
    mode = model.point_feats_inp.interp_mode
    reset_counts()
    lk, gk = train_pass(model, batch)
    expect_counts(read_counts(), per_pass, 1, f"one train pass ({mode})")
    lk2, gk2 = train_pass(model, batch)
    with plain_versions():
        lp, gp = train_pass(model, batch)
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
        lt, gt = train_pass(two_stage, batch)
        compare("the two-stage path", lt, gt)


def stage2_train_phase(card, model_f, model_points, grid_shape, n_points,
                       device="cuda", steps=STAGE2_TRAIN_STEPS,
                       per_step=(("voxelize", 2), ("compact", 8), ("fused", 8))) -> None:
    """The refiner's training through Solver(step_builder=...) with
    config_YCBV_bs40.yaml's optimizer and schedule at batch
    bs // ITERATIONS, on the frozen fused stage 1 (f32 or bf16; per_step:
    its forward kernels' launches a step): a warm-up step, then `steps`
    counted and timed steps."""
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
        length=bs * (steps + 1), seed=0)
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
    check(n == steps, f"{n} timed stage-2 steps")
    print(f"stage-2 train launches {launches} over {n} steps", flush=True)
    # the frozen stage 1: both branches forward, no backward kernel
    expect_counts(launches, dict(per_step), n, "stage-2 train")
    for key in ("loss_all", "loss_last_iter", "grad_norm"):
        check(bool(np.isfinite(avg[key])), f"stage-2 {key} not finite: {avg[key]}")
    check(avg["skipped_nonfinite"] == 0.0, "a stage-2 step was skipped as non-finite")
    check(all(not torch.equal(a, p) for a, p in zip(params0, refiner.parameters())),
          "some refiner parameter did not change")
    check(all(torch.equal(v, model_f.state_dict()[k]) for k, v in stage1.items()),
          "stage-2 training changed a stage-1 weight or BN statistic")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"stage-2 train ({'f32' if model_f.dtype is None else 'bf16'} stage 1) on "
          f"{card}: {n} steps of batch {bs} ({ITERATIONS} refinement "
          f"steps each) in {t_train:.3f} s = {n * bs / t_train:.2f} samples/s, T_step mean "
          f"{avg['T_step']:.4f} s, T_data mean {avg['T_data']:.4f} s, peak memory "
          f"{peak:.2f} GiB; mean loss_all "
          f"{avg['loss_all']:.5f} loss_last_iter {avg['loss_last_iter']:.5f} grad_norm "
          f"{avg['grad_norm']:.3f}", flush=True)


YCBV_FRAMES = 26  # 26 frames x 21 classes = 546 rows: one full batch of 512 and one padded
# launches per encode of the stage-1 CLI: the config's point-feature path
# (two-stage) and model.interp_mode=pallas_fused
CLI_KERNELS = {None: {"voxelize": 1, "compact": 4, "interp": 4},
               "pallas_fused": {"voxelize": 1, "compact": 4, "fused": 4},
               # under --override model.compute_dtype=bfloat16 (BF16_CLI)
               "bfloat16": {"voxelize_bf16": 1, "compact_bf16": 4, "interp_bf16": 4}}
BF16_CLI = "model.compute_dtype=bfloat16"


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


def cli_bf16_run(run, name: str, rows: int, probe, card: str, entries: dict,
                 launches_key: str) -> None:
    """Times one eval CLI run in bf16 (run() -> (result, seconds, launch
    counts), the CLI's own checks inside) and prints what a user of
    model.compute_dtype: bfloat16 pays at the eval batch of 512:
    instances/s, the model's seconds, peak device memory (beside the f32
    runs' printed above) and n_overflow; stores the bf16 kernels' launches
    in entries under launches_key."""
    import torch

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, t_main, counts = run()
    peak = torch.cuda.max_memory_allocated()
    for key, n in counts.items():
        if n:
            entries[key][launches_key] = n
    print(f"{name} CLI in bf16 at batch 512 on {card}: main {t_main:.3f} s = "
          f"{rows / t_main:.1f} instances/s end to end; evaluate loop {probe.t_evaluate:.3f} s "
          f"= {rows / probe.t_evaluate:.1f} instances/s, of which {probe.t_run:.3f} s in the "
          f"model and distances; peak device memory {peak / 2 ** 30:.2f} GiB "
          f"({(peak - base) / 2 ** 30:.2f} GiB above the {base / 2 ** 30:.2f} GiB held "
          f"before the run); n_scored {res['n_scored']} n_lost {res['n_lost']} n_overflow "
          f"{res['n_overflow']}; launches {counts}", flush=True)


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

        def cli(tool, config, bs, workers=None, mode=None, extra=(), bf16=False,
                device_path=False):
            """One CLI run at eval batch bs, with `workers` loader threads
            (default: the config's) and model.interp_mode `mode` (default:
            the config's), in bf16 where asked (BF16_CLI), on the device
            preprocessing path where asked (DEVICE_PATH); returns (result,
            seconds of main, launch counts)."""
            log_root = tmp / f"log{next(runs)}"
            over = [f"hyper_dataloader_test.bs={bs}"] + ([BF16_CLI] if bf16 else []) + (
                [DEVICE_PATH] if device_path else [])
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
            expect_counts(counts, CLI_KERNELS["bfloat16" if bf16 else mode], encodes,
                          f"{name} bs {bs} {mode} bf16 {bf16}")
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
        t_wait = probe.t_evaluate - probe.t_run

        # the device preprocessing path (raw candidates, the numpy tail on the
        # card), the config's loader threads, beside the run above
        torch.cuda.reset_peak_memory_stats()
        res_d, t_d, counts_d = cli(test_ycbv_stage1, "config_YCBV_bs32.yaml", bs, extra=stage1,
                                   device_path=True)
        peak_d = torch.cuda.max_memory_allocated()
        print(f"stage-1 CLI on the device preprocessing path ({DEVICE_PATH}) at batch {bs} on "
              f"{card}: main {t_d:.3f} s = {rows / t_d:.1f} instances/s end to end (numpy "
              f"path above: {rows / t_main:.1f}); evaluate loop {probe.t_evaluate:.3f} s = "
              f"{rows / probe.t_evaluate:.1f} instances/s, of which {probe.t_run:.3f} s in the "
              f"model and ADD-S and {probe.t_evaluate - probe.t_run:.3f} s waiting on the loader "
              f"(numpy path above: {t_wait:.3f} s); reader {probe.t_read:.3f} s over "
              f"{probe.frames} frames ({probe.t_read / probe.frames * 1e3:.1f} ms a frame); "
              f"peak device memory {peak_d / 2 ** 30:.2f} GiB; auc_mean {res_d['auc_mean']} "
              f"n_scored {res_d['n_scored']} n_lost {res_d['n_lost']} n_overflow "
              f"{res_d['n_overflow']}; launches {counts_d}", flush=True)
        for key in ("voxelize", "compact", "interp"):
            entries[key]["ycbv_cli_device_path_launches"] = counts_d[key]

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

        # bf16 (model.compute_dtype: bfloat16) at 512, the f32 checkpoint:
        # a warm-up, then timed with the config's loader threads
        cli(test_ycbv_stage1, "config_YCBV_bs32.yaml", 512, extra=stage1, bf16=True)
        cli_bf16_run(lambda: cli(test_ycbv_stage1, "config_YCBV_bs32.yaml", 512,
                                 extra=stage1, bf16=True),
                     "test_ycbv_stage1", rows, probe, card, entries, "ycbv_cli_launches")

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

        def cli(tool, bs, workers=None, mode=None, checkpoint=ckpt, extra=(), bf16=False):
            """One eval CLI run (`extra`: more config overrides; bf16:
            BF16_CLI); returns (result, seconds of main, launch counts)."""
            name = tool.__name__.rsplit(".", 1)[-1]
            rows, lost = trees[name]["eval_rows"], trees[name]["lost"]
            log_root = tmp / f"log{next(runs)}"
            over = [f"hyper_dataloader_test.bs={bs}", *extra] + ([BF16_CLI] if bf16 else [])
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
            expect_counts(counts, CLI_KERNELS["bfloat16" if bf16 else mode], 1 + -(-rows // bs),
                          f"{name} bs {bs} {mode} bf16 {bf16}")
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

        # test_lm in bf16 at 512: a warm-up, then timed with the config's threads
        cli(test_lm, 512, bf16=True)
        cli_bf16_run(lambda: cli(test_lm, 512, bf16=True), "test_lm",
                     lm_info["eval_rows"], probe, card, entries, "test_lm_cli_launches")

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


# ---- phase 13: the throughput training path ------------------------------------
THROUGHPUT_TIMED_STEPS = 3  # bs128 (device path and host path), after one warm-up step
PEAK_TIMED_STEPS = 2        # bs256 with remat, after one warm-up step
# bs256 in f32 with remat: a peak of 58.84 GiB on an 80 GB card (PERF.md,
# section 6)
PEAK_OVERRIDES = ["model.remat=true"]
DEVICE_PATH = "hyper_dataset_test.device_preprocess=True"
# preprocess_core on the card against its CPU run, the same draws: the
# einsums and sums in another order (tests/test_torch_device_preprocess.py)
PREPROCESS_ATOL = 3e-5


def busy_us(prof) -> float:
    """The union of the device kernels' intervals of a profile, in us."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


@contextmanager
def timed_steps(warmup: int):
    """Around one tools/train_stage1.main run: the host time from the start
    of the first step after `warmup` steps to the exit (after a
    synchronise), and the device's busy time in it from torch.profiler
    (kernels only). Yields a dict filled at the exit: seconds, busy_s,
    steps (train_step calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dcl_net_tpu_torch.train import solver as solver_mod

    out = {"steps": 0}
    prof = profile(activities=[ProfilerActivity.CUDA])
    make = solver_mod.make_train_step

    def wrapped_make(*a, **kw):
        step = make(*a, **kw)

        def counted(state, batch):
            if out["steps"] == warmup:
                prof.__enter__()
                out["t0"] = time.perf_counter()
            out["steps"] += 1
            return step(state, batch)

        return counted

    solver_mod.make_train_step = wrapped_make
    try:
        yield out
    except BaseException:
        if "t0" in out:
            prof.__exit__(None, None, None)
        raise
    finally:
        solver_mod.make_train_step = make
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - out["t0"]
    prof.__exit__(None, None, None)
    out["busy_s"] = busy_us(prof) / 1e6


def train_cli_run(tree: dict, tmp: Path, name: str, config: str, frames: int,
                  steps: int, overrides=()):
    """tools/train_stage1.main with `config` on the YCB-V tree, its train
    list `frames` entries long (the tree's frames cycled: each is decoded),
    one epoch of `steps` steps, the first a warm-up; checks finite losses,
    no skipped step, the launches of the two-stage path (K1 2, K2-K5 8 a
    step, in the model's dtype) and returns (figures, launch counts)."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.tools import train_stage1

    cfg = Config.fromfile(str(ROOT / "configs" / config)).apply_overrides(list(overrides))
    bs = int(cfg.hyper_dataloader_train.bs)
    spf = int(cfg.hyper_dataset_train.get("samples_per_frame", 1)) \
        if cfg.hyper_dataset_train.get("device_preprocess", False) else 1
    check(frames == steps * bs // spf, f"{name}: {frames} frames for {steps} steps")
    listed = (tree["frame_names"] * (frames // len(tree["frame_names"]) + 1))[:frames]
    Path(tree["assets"], "train_data_list.txt").write_text("\n".join(listed) + "\n")
    log_root = tmp / f"train_{name}"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with timed_steps(warmup=1) as timed:
        train_stage1.main(["--config", str(ROOT / "configs" / config), "--path_data",
                           tree["path_data"], "--log_root", str(log_root), "--override",
                           "max_epoch=1", "per_write=1", "per_save=0", *overrides])
    t_main = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    counts = read_counts()
    (exp_dir,) = log_root.glob("*")
    records = [json.loads(line) for line in
               (exp_dir / "scalars.jsonl").read_text().strip().splitlines()]
    check(len(records) == steps == timed["steps"], f"{name}: {len(records)} step records")
    for rec in records:
        for key in ("loss_all", "loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "grad_norm"):
            check(bool(np.isfinite(rec[key])), f"{name}: {key} not finite: {rec[key]}")
        check(rec["skipped_nonfinite"] == 0.0, f"{name}: a step was skipped")
    per_step = TWO_STAGE_TRAIN if cfg.model.get("compute_dtype") != "bfloat16" \
        else TWO_STAGE_TRAIN_BF16
    expect_counts(counts, per_step, steps, name)
    timed_recs = records[1:]
    fig = {"rate": (steps - 1) * bs / timed["seconds"],
           "t_step": float(np.mean([r["T_step"] for r in timed_recs])),
           "t_data": float(np.sum([r["T_data"] for r in timed_recs])),
           "seconds": timed["seconds"], "idle": 1.0 - timed["busy_s"] / timed["seconds"],
           "peak_gib": peak, "warmup_s": timed["t0"] - t0,
           "first_batch_s": records[0]["T_data"],
           "main_s": t_main, "losses": [round(r["loss_all"], 5) for r in records]}
    return fig, counts


def print_train_run(name: str, card: str, bs: int, steps: int, fig: dict) -> None:
    print(f"{name} on {card}: {steps - 1} timed steps of batch {bs} in {fig['seconds']:.3f} s "
          f"= {fig['rate']:.2f} samples/s; T_step mean {fig['t_step']:.4f} s; waiting on "
          f"the loader {fig['t_data']:.3f} s of the {steps - 1} steps; device idle share "
          f"{100 * fig['idle']:.1f} % (torch.profiler, kernels only); peak device memory "
          f"{fig['peak_gib']:.2f} GiB; set-up and warm-up step {fig['warmup_s']:.3f} s (the "
          f"first batch's wait {fig['first_batch_s']:.3f} s of it; cuDNN's autotuning at new "
          f"shapes), main {fig['main_s']:.3f} s; losses {fig['losses']}", flush=True)


def remat_parity(card: str, mcfg, batch) -> None:
    """(a) One train-mode forward and backward at full width in f32 from one
    state, without and with model.remat: losses torch.equal, the flat
    gradient within TRAIN_GRAD_REL_L2, the BN running statistics after the
    forward torch.equal (the recomputation leaves them), the same kernel
    launches (no hand kernel lies inside the backbone); peak memory of each."""
    import torch

    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.train.solver import bn_statistics

    def one_pass(model):
        model.train()
        stats = bn_statistics(model)
        saved = [s.clone() for s in stats]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses = dcl_losses(model(batch), batch)
        grads = torch.autograd.grad(losses["loss_all"], list(model.parameters()))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        counts = read_counts()
        after = [s.clone() for s in stats]
        with torch.no_grad():
            for s, v in zip(stats, saved):
                s.copy_(v)
        return ({k: v.detach() for k, v in losses.items()},
                torch.cat([g.reshape(-1) for g in grads]), after, counts, peak)

    plain = DCLNet.from_config(mcfg, seed=0)
    one_pass(plain)  # warm-up: cuDNN's algorithm choice, the allocator
    l0, g0, s0, c0, p0 = one_pass(plain)
    del plain
    remat = DCLNet.from_config({**mcfg.to_dict(), "remat": True}, seed=0)
    check(remat.remat, "model.remat did not reach the model")
    l1, g1, s1, c1, p1 = one_pass(remat)
    del remat
    rel = float((g1 - g0).norm()) / float(g0.norm())
    same_loss = all(torch.equal(l0[k], l1[k]) for k in l0)
    same_stats = all(torch.equal(a, b) for a, b in zip(s0, s1))
    print(f"remat at batch {BATCH}, f32, full width, on {card}: losses torch.equal "
          f"{same_loss}, gradient rel L2 {rel:.3g}, BN running statistics torch.equal "
          f"{same_stats}, launches {c1} (without remat {c0}); peak device memory of a "
          f"forward + backward {p1:.2f} GiB with remat, {p0:.2f} GiB without", flush=True)
    check(same_loss, "remat changed the losses")
    check(rel <= TRAIN_GRAD_REL_L2, f"remat moved the gradient by {rel} in relative L2")
    check(same_stats, "remat changed the BN running statistics")
    check(c0 == c1, "remat changed the kernels' launch counts")
    expect_counts(c1, TWO_STAGE_TRAIN, 1, "one train pass with remat")


def preprocess_on_card(card: str, tree: dict) -> None:
    """(e) preprocess_core on the card against its CPU run, on one raw batch
    of the bs128 shape (64 frames of the YCB-V tree, 2 draws each, 8192
    candidates) with injected draws, for the train path (augmentation,
    min_points 50) and the eval path (keep-clamp 32): outputs within
    PREPROCESS_ATOL, voxel ids equal off voxel boundaries and within one on
    them; then DevicePreprocessor's time a batch on the card."""
    import random

    import numpy as np
    import torch

    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.data import device_preprocess as dp
    from dcl_net_tpu_torch.data.ycbv import YCBVTrainDataset

    cfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs128_throughput.yaml"))
    ds_cfg = cfg.hyper_dataset_train
    frames = tree["frame_names"] * 3
    Path(tree["assets"], "train_data_list.txt").write_text("\n".join(frames[:64]) + "\n")
    ds = YCBVTrainDataset(ds_cfg, tree["root"], assets_dir=tree["assets"])
    np.random.seed(0)
    random.seed(0)
    t0 = time.perf_counter()
    samples = [s for i in range(len(ds)) for s in ds[i]]
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = dp.make_raw_batch(samples, pad_to=int(cfg.hyper_dataloader_train.bs))
    t_collate = time.perf_counter() - t0
    b = raw["valid"].shape[0]
    rng = np.random.RandomState(1)
    angles = rng.uniform(-np.pi / 36, np.pi / 36, (b, 3)).astype(np.float32)
    tjit = rng.uniform(-0.03, 0.03, (b, 3)).astype(np.float32)
    n_points = int(ds_cfg.input_size)
    idx = np.stack([rng.randint(0, max(int(c), 1), n_points) for c in raw["n_cand"]])
    unit = tuple(float(u) for u in ds_cfg.unit_voxel_extent)
    limit = tuple(int(v) for v in ds_cfg.voxel_num_limit)
    static = dict(n_points=n_points, unit=unit, total=tuple(u * v for u, v in zip(unit, limit)),
                  limit=limit, min_points=50)
    for what, kw in (("train", dict(augment=True, eval_keep_clamp=False)),
                     ("eval", dict(augment=False, eval_keep_clamp=True,
                                   keep_clamp_threshold=32))):
        outs = {}
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            rawt = {k: dp._to_device(raw[k], d) for k in dp.RAW_KEYS}
            outs[dev] = {k: v.cpu() for k, v in dp.preprocess_core(
                rawt, torch.from_numpy(angles).to(d), torch.from_numpy(tjit).to(d),
                torch.from_numpy(idx).to(d), None, **static, **kw).items()}
        got, want = outs["cuda"], outs["cpu"]
        errs = {k: max_err(got[k], want[k]) for k in ("inp_feats", "rot_gt", "trans_gt")}
        xyz = want["inp_feats"][..., 4:7].double()
        pos = (xyz + static["total"][0] / 2) / unit[0]
        near = ((pos - pos.round()).abs() * unit[0] < PREPROCESS_ATOL).any(-1)
        diff = (got["inp_voxel_idx"] - want["inp_voxel_idx"]).abs().amax(-1)
        k = raw["cand_depth"].shape[1]
        print(f"preprocess_core ({what}) on the card vs the CPU, [{b}, {k}] candidates -> "
              f"{n_points} points: max abs error {errs}; voxel ids differ at "
              f"{int((diff > 0).sum())} points, all within one and on a voxel boundary: "
              f"{bool((diff <= 1).all() and not ((diff > 0) & ~near).any())}; valid equal "
              f"{torch.equal(got['valid'], want['valid'])}", flush=True)
        check(all(e <= PREPROCESS_ATOL for e in errs.values()),
              f"preprocess_core ({what}) on the card is off its CPU run: {errs}")
        check(bool((diff <= 1).all()) and not bool(((diff > 0) & ~near).any()),
              f"preprocess_core ({what}): voxel ids differ off a voxel boundary")
        check(torch.equal(got["valid"], want["valid"]), f"preprocess_core ({what}): valid")
    pre = dp.DevicePreprocessor(n_points, unit, limit, augment=True, min_points=50, seed=1)
    for _ in range(3):
        pre(raw)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        out = pre(raw)
        out.ready.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"DevicePreprocessor on {card}, batch {b} of {raw['cand_depth'].shape[1]} candidates: "
          f"{1e3 * statistics.median(times):.2f} ms a batch (host clock to its event, median "
          f"of 10, host-to-device copies included); the host's read of the 64 frames "
          f"{t_read:.3f} s in one thread, make_raw_batch {1e3 * t_collate:.1f} ms", flush=True)


def throughput_phase(card: str, entries: dict, mcfg, train_batch) -> None:
    """Phase 13, the throughput training path: (a) remat parity at batch 32;
    (b) configs/config_YCBV_bs128_throughput.yaml as written through
    tools/train_stage1.main on a YCB-V tree (device preprocessing, 2 draws
    a frame, 10 process workers, the template bank), then the same config
    on the numpy path (device_preprocess False, samples_per_frame 1, thread
    workers); (c) configs/config_YCBV_bs256_peak.yaml with PEAK_OVERRIDES;
    (e) preprocess_core on the card against the CPU."""
    import importlib.util
    import tempfile

    import torch

    t_phase = time.perf_counter()
    remat_parity(card, mcfg, train_batch)
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location("ycbv_tree", ROOT / "scripts" / "ycbv_tree.py")
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    with tempfile.TemporaryDirectory(prefix="dclx_train_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        tree = writer.write_tree(str(tmp / "data"), n_classes=21, n_frames=YCBV_FRAMES)
        tree["frame_names"] = Path(tree["assets"], "train_data_list.txt").read_text().split()
        print(f"YCB-V tree for training: {YCBV_FRAMES} frames written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        preprocess_on_card(card, tree)

        steps = THROUGHPUT_TIMED_STEPS + 1
        dev_fig, counts = train_cli_run(tree, tmp, "bs128_device",
                                        "config_YCBV_bs128_throughput.yaml",
                                        frames=steps * 64, steps=steps)
        for key, n in counts.items():
            if n:
                entries[key]["throughput_train_launches"] = n
        print_train_run(f"config_YCBV_bs128_throughput.yaml as written ({steps * 64} frames in "
                        "the train list, device preprocessing, 2 draws a frame, 10 process "
                        "workers, template bank)", card, 128, steps, dev_fig)
        host_fig, _ = train_cli_run(
            tree, tmp, "bs128_host", "config_YCBV_bs128_throughput.yaml", frames=steps * 128,
            steps=steps, overrides=["hyper_dataset_train.device_preprocess=False",
                                    "hyper_dataset_train.samples_per_frame=1",
                                    "hyper_dataloader_train.worker_type=thread"])
        print_train_run(f"config_YCBV_bs128_throughput.yaml on the numpy path ({steps * 128} "
                        "frames, device_preprocess False, samples_per_frame 1, 10 thread "
                        "workers, template bank)", card, 128, steps, host_fig)
        print(f"bs128 on {card}: device path {dev_fig['rate']:.2f} samples/s, loader wait "
              f"{dev_fig['t_data']:.3f} s; numpy path {host_fig['rate']:.2f} samples/s, loader "
              f"wait {host_fig['t_data']:.3f} s", flush=True)

        steps = PEAK_TIMED_STEPS + 1
        peak_fig, counts = train_cli_run(tree, tmp, "bs256_peak", "config_YCBV_bs256_peak.yaml",
                                         frames=steps * 256, steps=steps,
                                         overrides=PEAK_OVERRIDES)
        for key, n in counts.items():
            if n:
                entries[key]["peak_train_launches"] = n
        print_train_run(f"config_YCBV_bs256_peak.yaml with {' '.join(PEAK_OVERRIDES)} "
                        f"({steps * 256} frames, 10 process workers, template bank)", card, 256,
                        steps, peak_fig)
    print(f"throughput training phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- phase 14: serving --------------------------------------------------------
SERVE_BATCHES = (1, 16, 64, 512)  # the fixed-batch artifacts of the bundle (the CLI's default)
SERVE_REQUESTS = (1, 5, 32, 100, 512, 700)  # 700: a chunk of 512, then one of 188 padded
POLY_REQUESTS = (3, 40)
SERVE_RATE_CALLS = {BATCH: 20, 512: 4}  # timed requests at each size, after a warm-up
TWO_STAGE_ENCODE = {"voxelize": 1, "compact": 4, "interp": 4}
FUSED_ENCODE = {"voxelize": 1, "compact": 4, "fused": 4}
# the child process of the fresh-load check: it imports dcl_net_tpu_torch.serving and
# nothing else of the repository, loads the bundle from disk and serves one request
SERVE_CHILD = """
import sys
import torch
from dcl_net_tpu_torch.serving import BundleServer
bundle, request, out = sys.argv[1:]
torch.save(BundleServer(bundle)(*torch.load(request)), out)
"""


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of fn, over `calls` calls after a warm-up
    (inputs small enough that the card keeps up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def opcheck_on_card(batch, entries: dict) -> None:
    """torch.library.opcheck of each dclx op on the card, f32 and bf16, on
    the first 4 rows of a batch at a 16^3 grid: the fake implementations
    give the shapes, types and strides the kernels write. Then the host
    cost of a call through each f32 op against a direct call of its launch
    (`*_kernel`), the op dispatch's share (entries: op_host_us,
    launch_host_us)."""
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.ops import (
        cuda_compact, cuda_fused, cuda_interp, cuda_voxelize, library,
    )

    tb = batch_to_torch(batch, "cuda")
    feats = tb["inp"]["feats"][:4].contiguous()
    vidx = torch.clamp(tb["inp"]["voxel_idx"][:4] // 4, max=15).contiguous()
    ops = torch.ops.dclx
    for dtype in (torch.float32, torch.bfloat16):
        grid, count = ops.voxelize(feats, vidx, [16, 16, 16], 4, None, dtype)
        mask = (count > 0).to(torch.float32)
        cases = {"voxelize": (feats, vidx, [16, 16, 16], 4, None, dtype),
                 "dense_to_sparse": (grid, mask, 512)}
        coords, rows, vmask, occ = cuda_compact.dense_to_sparse_cuda(grid, mask, 512)
        points = feats[..., 4:7].contiguous()
        centers = coords.to(torch.float32) * 0.024 - 0.18
        cases["nn_interpolate"] = (points, centers, rows, vmask, occ)
        cases["compact_interpolate"] = (points, coords, rows, vmask, occ, [0.024] * 3,
                                        [-0.18] * 3)
        for name in library.OPS:
            torch.library.opcheck(getattr(ops, name).default, cases[name])
    torch.cuda.synchronize()
    print(f"opcheck of the dclx ops {library.OPS} on the card, f32 and bf16: passed",
          flush=True)
    launch = {"voxelize": cuda_voxelize.voxelize_kernel,
              "dense_to_sparse": cuda_compact.dense_to_sparse_kernel,
              "nn_interpolate": cuda_interp.nn_interpolate_kernel,
              "compact_interpolate": cuda_fused.compact_interpolate_kernel}
    keys = {"voxelize": "voxelize", "dense_to_sparse": "compact", "nn_interpolate": "interp",
            "compact_interpolate": "fused"}
    for name, args in cases.items():  # the bf16 cases
        args = tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                     else a for a in args)
        if name == "voxelize":
            args = args[:-1] + (None,)
        op = getattr(ops, name)
        e = entries[keys[name]]
        e["op_host_us"] = host_us(lambda: op(*args))
        e["launch_host_us"] = host_us(lambda: launch[name](*args))
        print(f"dclx::{name} on {tuple(args[0].shape)}: {e['op_host_us']:.1f} us a call "
              f"through the op, {e['launch_host_us']:.1f} us through its launch function "
              f"(host clock, 200 calls)", flush=True)


def serve_request(server, pool: dict, n: int):
    """Rows np.resize(arange(rows), n) of pool (feats, voxel_idx, obj_idx on
    the card, and the Evaluator's rot_pred, trans_pred, overflow of each
    row), served by `server`: (the served outputs, the Evaluator's rows,
    the chunks' launch counts)."""
    import numpy as np
    import torch

    idx = torch.as_tensor(np.resize(np.arange(pool["feats"].shape[0]), n), device="cuda")
    reset_counts()
    out = server(pool["feats"][idx], pool["voxel_idx"][idx], pool["obj_idx"][idx])
    torch.cuda.synchronize()
    return out, {k: pool[k][idx] for k in ("rot_pred", "trans_pred", "overflow")}, read_counts()


def check_served(what: str, out, ref, rows: int, deg: float = None, mm: float = None):
    """Served poses against the Evaluator's rows: within POSE_ATOL (or within
    deg and mm, bf16), overflow equal; returns the largest differences."""
    import torch

    check(tuple(out["rot_pred"].shape) == (rows, 3, 3) and tuple(out["trans_pred"].shape)
          == (rows, 3), f"{what}: output shapes")
    check(bool(torch.isfinite(out["rot_pred"]).all() and torch.isfinite(out["trans_pred"]).all()),
          f"{what}: non-finite poses")
    check(torch.equal(out["overflow"], ref["overflow"]), f"{what}: overflow differs")
    if deg is not None:
        keep = torch.ones(rows, dtype=torch.bool, device=out["rot_pred"].device)
        d_rot, d_trans = pose_drift(out, ref, keep)
        check(d_rot.max() < deg and d_trans.max() < mm,
              f"{what}: rot {d_rot.max():.4g} deg trans {d_trans.max():.4g} mm")
        return float(d_rot.max()), float(d_trans.max())
    e_rot = max_err(out["rot_pred"], ref["rot_pred"])
    e_trans = max_err(out["trans_pred"].float(), ref["trans_pred"])
    check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL,
          f"{what}: rot_pred {e_rot:.3g} trans_pred {e_trans:.3g} above {POSE_ATOL}")
    return e_rot, e_trans


def evaluator_rows(ev, batches) -> dict:
    """Each row of the batches on the card with the Evaluator's pose and
    overflow flag for it."""
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch

    dev = torch.device("cuda")
    tbs = [batch_to_torch(b, dev) for b in batches]
    outs = [ev._run(tb) for tb in tbs]
    pool = {"feats": torch.cat([tb["inp"]["feats"] for tb in tbs]),
            "voxel_idx": torch.cat([tb["inp"]["voxel_idx"] for tb in tbs]),
            "obj_idx": torch.cat([tb["labels"]["obj_idx"] for tb in tbs])}
    for k in ("rot_pred", "trans_pred", "overflow"):
        pool[k] = torch.cat([o[k] for o in outs])
    return pool


def served_rate(fn, pool: dict, n: int) -> float:
    """Instances/s of `fn` on requests of n rows of pool, over
    SERVE_RATE_CALLS[n] calls after one warm-up call (host clock, card
    synchronised)."""
    import numpy as np
    import torch

    idx = torch.as_tensor(np.resize(np.arange(pool["feats"].shape[0]), n), device="cuda")
    args = (pool["feats"][idx], pool["voxel_idx"][idx], pool["obj_idx"][idx])
    calls = SERVE_RATE_CALLS[n]
    with torch.inference_mode():
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    return n * calls / (time.perf_counter() - t0)


def serving_phase(card: str, mcfg, model, model_f, batches, bank, model_points,
                  eval_rate: float, entries: dict) -> None:
    """Phase 14, serving (dcl_net_tpu_torch/serving.py): a two-stage f32
    bundle (SERVE_BATCHES + the poly artifact) exported and served through
    a fresh BundleServer at SERVE_REQUESTS, each row against Evaluator's
    (POSE_ATOL, overflow equal) and each chunk's launches K1 1, K2 4, K3 4
    (no template encode); the poly artifact at POLY_REQUESTS; a fused
    stage-2 artifact against Stage2Evaluator; a bf16 artifact at BATCH
    against the bf16 Evaluator (bf16 kernels only, BF16_POSE_DEG,
    BF16_POSE_MM); a child process that imports only serving.py, loads the
    bundle from disk and serves one request torch.equal to this process;
    each artifact's export seconds and bytes, and served instances/s at 32
    and 512 beside the Evaluator's (phase 4) and the eager serving
    module's. cuDNN's autotuning is off, as in phase 4."""
    import tempfile

    import torch

    from dcl_net_tpu_torch import serving
    from dcl_net_tpu_torch.eval.evaluator import Evaluator, Stage2Evaluator
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.models.refiner import Refiner

    t_phase = time.perf_counter()
    saved_benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    opcheck_on_card(batches[0], entries)
    n_points = int(mcfg.n_inp)
    pool = evaluator_rows(Evaluator(model, model_points, template_bank=bank), batches)
    serve_counts = {k: 0 for k in KERNEL_ORDER}
    with tempfile.TemporaryDirectory(prefix="dclx_serve_") as tmp:
        tmp = Path(tmp)
        # ---- the two-stage f32 bundle, each artifact's export timed
        export_s = {}
        export = serving._export

        def timed_export(serve, batch_size, n):
            t0 = time.perf_counter()
            data = export(serve, batch_size, n)
            export_s["poly" if batch_size is None else f"b{batch_size:05d}"] = (
                time.perf_counter() - t0)
            return data

        serving._export = timed_export
        t0 = time.perf_counter()
        try:
            arts = serving.export_bundle(model, bank, n_points, batch_sizes=SERVE_BATCHES)
        finally:
            serving._export = export
        t_export = time.perf_counter() - t0
        serving.save_bundle(str(tmp / "bundle"), arts, model)
        print(f"serving bundle exported on {card} in {t_export:.1f} s (one template encode, "
              f"{len(arts)} artifacts): " + ", ".join(
                  f"{name} {export_s[name]:.1f} s {len(data)} bytes"
                  for name, data in arts.items()), flush=True)
        server = serving.BundleServer(str(tmp / "bundle"))
        check(server.fixed_sizes == list(SERVE_BATCHES) and server.has_poly
              and server.device.type == "cuda",
              f"bundle manifest: {server.fixed_sizes} {server.has_poly} {server.device}")
        t0 = time.perf_counter()
        for name in arts:
            server._fn(name)
        print(f"bundle loaded in {time.perf_counter() - t0:.1f} s ({len(arts)} artifacts)",
              flush=True)
        for n in SERVE_REQUESTS:
            out, ref, counts = serve_request(server, pool, n)
            chunks = -(-n // SERVE_BATCHES[-1])
            expect_counts(counts, TWO_STAGE_ENCODE, chunks, f"served request of {n}")
            for k, c in counts.items():
                serve_counts[k] += c
            e_rot, e_trans = check_served(f"served request of {n}", out, ref, n)
            print(f"served {n} rows in {chunks} chunk(s): rot_pred {e_rot:.3g} trans_pred "
                  f"{e_trans:.3g} from Evaluator's; launches {counts}", flush=True)
        poly = serving.load_serve(str(tmp / "bundle" / "poly.pt2"))
        for n in POLY_REQUESTS:
            out, ref, counts = serve_request(poly, pool, n)
            expect_counts(counts, TWO_STAGE_ENCODE, 1, f"poly request of {n}")
            e_rot, e_trans = check_served(f"poly request of {n}", out, ref, n)
            for k, c in counts.items():
                serve_counts[k] += c
            print(f"poly artifact (batch in [1, {server.poly_max}]) served {n} rows: rot_pred "
                  f"{e_rot:.3g} trans_pred {e_trans:.3g} from Evaluator's", flush=True)

        # ---- a fresh process: serving.py alone, the bundle from disk
        request = tuple(pool[k][:5].cpu() for k in ("feats", "voxel_idx", "obj_idx"))
        torch.save(request, tmp / "request.pt")
        here = server(*request)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", SERVE_CHILD, str(tmp / "bundle"), str(tmp / "request.pt"),
             str(tmp / "served.pt")], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=600)
        check(child.returncode == 0, f"serving child process failed:\n{child.stdout[-4000:]}")
        there = torch.load(tmp / "served.pt")
        check(set(there) == set(here) and all(torch.equal(there[k].cuda(), here[k])
                                              for k in here),
              "the fresh process's outputs differ from this process's")
        print(f"fresh process (imports dcl_net_tpu_torch.serving only) loaded the bundle and "
              f"served 5 rows torch.equal to this process in {time.perf_counter() - t0:.1f} s",
              flush=True)

        # ---- rates: the bundle (which pads 32 into its artifact of 64), the
        # poly artifact at 32, the eager serving module, the Evaluator
        eager = serving.make_serve_fn(model, serving.encode_template_cache(model, bank))
        rates = {n: (served_rate(server, pool, n), served_rate(eager, pool, n))
                 for n in SERVE_RATE_CALLS}
        print(f"served instances/s on {card}: " + "; ".join(
            f"batch {n}: bundle {r[0]:.1f}, eager serving module {r[1]:.1f}"
            for n, r in rates.items()) + f"; poly artifact at {BATCH} "
            f"{served_rate(poly, pool, BATCH):.1f}; Evaluator at batch {BATCH} in phase 4 "
            f"{eval_rate:.1f} (ADD-S and host copies included)", flush=True)
        del server, poly, eager, arts
        torch.cuda.empty_cache()

        # ---- a fused stage-2 artifact against Stage2Evaluator
        refiner = Refiner(n_inp=n_points, seed=0)
        t0 = time.perf_counter()
        data = serving.export_serve_stage2(model_f, refiner, bank, BATCH, iterations=ITERATIONS)
        t_export = time.perf_counter() - t0
        serve2 = serving.load_serve(data)
        ev2 = Stage2Evaluator(model_f, refiner, model_points, iterations=ITERATIONS,
                              template_bank=bank)
        pool2 = evaluator_rows(ev2, batches[:2])
        for i in range(2):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            reset_counts()
            with torch.inference_mode():
                out = serve2(pool2["feats"][sl], pool2["voxel_idx"][sl], pool2["obj_idx"][sl])
            torch.cuda.synchronize()
            counts = read_counts()
            expect_counts(counts, FUSED_ENCODE, 1, "served stage-2 batch")
            for k, c in counts.items():
                serve_counts[k] += c
            check(set(out) == {"rot_pred", "trans_pred", "conf", "overflow", "rot_stage1",
                               "trans_stage1"}, f"stage-2 artifact outputs {sorted(out)}")
            e_rot, e_trans = check_served("served stage-2 batch", out,
                                          {k: v[sl] for k, v in pool2.items()}, BATCH)
        print(f"fused stage-2 artifact ({ITERATIONS} refinement steps, batch {BATCH}): exported "
              f"in {t_export:.1f} s, {len(data)} bytes; rot {e_rot:.3g} trans {e_trans:.3g} "
              f"from Stage2Evaluator's", flush=True)
        del serve2, ev2, data

        # ---- a bf16 artifact against the bf16 Evaluator
        model_b = DCLNet.from_config(mcfg, seed=0, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        data = serving.export_serve(model_b, bank, BATCH, n_points)
        t_export = time.perf_counter() - t0
        serve_b = serving.load_serve(data)
        pool_b = evaluator_rows(Evaluator(model_b, model_points, template_bank=bank),
                                batches[:2])
        worst = (0.0, 0.0)
        for i in range(2):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            reset_counts()
            with torch.inference_mode():
                out = serve_b(pool_b["feats"][sl], pool_b["voxel_idx"][sl],
                              pool_b["obj_idx"][sl])
            torch.cuda.synchronize()
            counts = read_counts()
            expect_counts(counts, {f"{k}_bf16": c for k, c in TWO_STAGE_ENCODE.items()}, 1,
                          "served bf16 batch")
            for k, c in counts.items():
                serve_counts[k] += c
            check(out["trans_pred"].dtype == torch.bfloat16, "bf16 artifact: trans_pred "
                  f"{out['trans_pred'].dtype}")
            d = check_served("served bf16 batch", out, {k: v[sl] for k, v in pool_b.items()},
                             BATCH, BF16_POSE_DEG, BF16_POSE_MM)
            worst = tuple(max(a, b) for a, b in zip(worst, d))
        print(f"bf16 artifact (batch {BATCH}): exported in {t_export:.1f} s, {len(data)} bytes; "
              f"rot {worst[0]:.4g} deg, trans {worst[1]:.4g} mm from the bf16 Evaluator's "
              f"(bound {BF16_POSE_DEG} deg, {BF16_POSE_MM} mm)", flush=True)
        del serve_b, model_b, data
    for key, n in serve_counts.items():
        if n:
            entries[key]["serve_launches"] = n  # every served request of the phase
    torch.backends.cudnn.benchmark = saved_benchmark
    torch.cuda.empty_cache()
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- phase 15: data parallelism ------------------------------------------------
PARALLEL_BATCH = 8  # the global batch of the phase's training runs: 4 rows a rank
PARALLEL_STEPS = 3  # train steps a path, each on its own global batch
PARALLEL_EVAL_BATCHES = 2  # global eval batches of BATCH rows
PARALLEL_WORLD = 2
PARALLEL_TIMEOUT = 420.0  # seconds the ranks may take, start-up included
# later steps of a data-parallel run against one process: Adam (eps 1e-6)
# turns last-bit differences of small gradient entries into steps of either
# sign, as the JAX package's multi-host dryrun bounds them
# (tests/test_multihost.py:85-86)
PARALLEL_LATER_RTOL = 5e-2
# one all-reduce of the flat gradient: every parameter of the stage-1 model
FLAT_GRAD_NUMEL = 8_393_972


def same_on_every_rank(tensors, group) -> bool:
    """Whether every rank holds rank 0's values of `tensors` (one broadcast
    and one all-reduce)."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    differ = torch.tensor([0.0 if torch.equal(ref, flat) else 1.0], device=flat.device)
    dist.all_reduce(differ)
    return float(differ) == 0.0


def parallel_train(cfg, interp_mode: str, global_batches, group=None):
    """PARALLEL_STEPS stage-1 train steps at full width through
    make_parallel_train_step (seeded weights, cfg's optimizer), each on
    this rank's block of a global batch (the whole batch without a group).
    Returns the steps' metrics and seconds, the first step's flat gradient
    (after the all-reduce), the launch counts of the steps and whether
    every rank held the same parameters after every step."""
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.parallel.mesh import make_parallel_train_step, shard_batch
    from dcl_net_tpu_torch.train.solver import TrainState, build_optimizer

    dev = torch.device("cuda")
    model = DCLNet.from_config(cfg.model, seed=0, device=dev, interp_mode=interp_mode)
    opt, _ = build_optimizer(cfg, 1)
    grads = []
    update = opt.update

    def record(grad, norm, state):
        if not grads:
            grads.append(grad.detach().clone())
        return update(grad, norm, state)

    opt.update = record
    step = make_parallel_train_step(model, opt, dcl_losses, group)
    params = [p for p in model.parameters() if p.requires_grad]
    state = TrainState(opt.init(sum(p.numel() for p in params), dev))
    blocks = [batch_to_torch(shard_batch(b, group), dev) for b in global_batches]
    torch.cuda.synchronize()
    reset_counts()
    steps, same = [], True
    for b in blocks:
        t0 = time.perf_counter()
        metrics = step(state, b)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "seconds": seconds})
        if group is not None:
            same = same and same_on_every_rank(params, group)
    return {"steps": steps, "grad": grads[0], "counts": read_counts(), "same_params": same}


def world1_lockstep(cfg, global_batches, group):
    """Phase 15(a): a two-stage model stepping under the world-1 `group` and
    one without a group, in lockstep: at every step both start from the
    state of the one without (the other's parameters, BN statistics and
    optimizer state are copied over after each step). The forward is
    deterministic, so the losses and BN statistics must be torch.equal and
    no collective may be issued; the gradients are held within
    TRAIN_GRAD_REL_L2, because the backward is not bit-reproducible on the
    card (avg_pool3d's CUDA backward adds with atomics, which PyTorch lists
    as nondeterministic): two runs without a group differ as much. Returns
    (the launch counts of the group's steps, each step's gradient rel L2)."""
    import torch
    import torch.distributed as dist

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.parallel.mesh import make_parallel_train_step
    from dcl_net_tpu_torch.train.solver import TrainState, bn_statistics, build_optimizer

    dev = torch.device("cuda")
    runs = []
    for g in (None, group):
        model = DCLNet.from_config(cfg.model, seed=0, device=dev)
        opt, _ = build_optimizer(cfg, 1)
        grads = []
        update = opt.update

        def record(grad, norm, state, grads=grads, update=update):
            grads.append(grad.detach().clone())
            return update(grad, norm, state)

        opt.update = record
        step = make_parallel_train_step(model, opt, dcl_losses, g)
        params = [p for p in model.parameters() if p.requires_grad]
        runs.append({"model": model, "step": step, "grads": grads, "params": params,
                     "stats": bn_statistics(model),
                     "state": TrainState(opt.init(sum(p.numel() for p in params), dev))})
    ref, grp = runs
    calls = []
    names = ("all_reduce", "broadcast", "all_gather", "barrier", "reduce_scatter_tensor",
             "all_gather_into_tensor")
    originals = {n: getattr(dist, n) for n in names}

    def counting(name):
        def call(*a, **k):
            calls.append(name)
            return originals[name](*a, **k)
        return call

    rel, counts = [], {k: 0 for k in KERNEL_ORDER}
    for k, b in enumerate(global_batches):
        tb = batch_to_torch(b, dev)
        m_ref = ref["step"](ref["state"], tb)
        torch.cuda.synchronize()
        reset_counts()
        for n in names:
            setattr(dist, n, counting(n))
        try:
            m_grp = grp["step"](grp["state"], tb)
            torch.cuda.synchronize()
        finally:
            for n, f in originals.items():
                setattr(dist, n, f)
        for key, n in read_counts().items():
            counts[key] += n
        for key in ("loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "loss_all",
                    "overflow_frac", "skipped_nonfinite"):
            check(torch.equal(m_ref[key], m_grp[key]),
                  f"world-1 NCCL step {k + 1}: {key} {float(m_grp[key])} != "
                  f"{float(m_ref[key])}")
        check(all(torch.equal(a, c) for a, c in zip(ref["stats"], grp["stats"])),
              f"world-1 NCCL step {k + 1}: BN statistics differ")
        g_ref, g_grp = ref["grads"][-1], grp["grads"][-1]
        rel.append(float((g_grp - g_ref).norm() / g_ref.norm()))
        check(rel[-1] <= TRAIN_GRAD_REL_L2,
              f"world-1 NCCL step {k + 1}: gradient rel L2 {rel[-1]}")
        with torch.no_grad():  # the next step starts from the same state
            for a, c in zip(grp["params"] + grp["stats"], ref["params"] + ref["stats"]):
                a.copy_(c)
        grp["state"].opt_state = {n: v.clone() for n, v in ref["state"].opt_state.items()}
    check(not calls, f"the world-1 group issued collectives: {sorted(set(calls))}")
    expect_counts(counts, TWO_STAGE_TRAIN, PARALLEL_STEPS, "world-1 NCCL train")
    return counts, rel


def parallel_stage2(cfg, n_points: int, model_points, global_batch, group=None) -> dict:
    """One refiner train step on a frozen fused stage 1 (seeded weights)
    on this rank's block of global_batch: its losses and launch counts."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.parallel.mesh import replicate, shard_batch
    from dcl_net_tpu_torch.train.solver import TrainState, build_optimizer
    from dcl_net_tpu_torch.train.stage2 import make_stage2_train_step

    dev = torch.device("cuda")
    stage1 = DCLNet.from_config(cfg.model, seed=0, device=dev, interp_mode="pallas_fused")
    refiner = replicate(Refiner(n_inp=n_points, seed=1, device=dev), group)
    opt, _ = build_optimizer(cfg, 1)
    cld = torch.as_tensor(np.asarray(model_points, np.float32), device=dev)
    step = make_stage2_train_step(stage1, refiner, opt, ITERATIONS, cld, group=group)
    state = TrainState(opt.init(sum(p.numel() for p in refiner.parameters()), dev))
    batch = batch_to_torch(shard_batch(global_batch, group), dev)
    reset_counts()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "counts": read_counts()}


def parallel_eval(cfg, model_points, bank, global_batches, group=None) -> dict:
    """Evaluator (two-stage, seeded weights, template bank) over this rank's
    blocks of the global batches: its summary, seconds and launch counts."""
    import torch

    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.parallel.mesh import shard_batch

    model = DCLNet.from_config(cfg.model, seed=0, device=torch.device("cuda"))
    blocks = [shard_batch(b, group) for b in global_batches]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = Evaluator(model, model_points, template_bank=bank, group=group).evaluate(blocks)
    torch.cuda.synchronize()
    return {"summary": {k: res[k] for k in ("auc_mean", "acc_mean", "n_scored", "n_overflow")},
            "seconds": time.perf_counter() - t0, "counts": read_counts()}


def _parallel_rank(rank: int, world: int, init: str, tmp: str) -> None:
    """One rank of phase 15(b, c): gloo on cuda:0 (a test arrangement of one
    card; the CLIs run NCCL, one rank a GPU). Leaves its results in
    <tmp>/rank<r>.pt."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import strict_f32
    from dcl_net_tpu_torch.config import Config
    from dcl_net_tpu_torch.parallel.mesh import destroy, init_distributed

    strict_f32()
    torch.backends.cudnn.benchmark = False  # no autotuning of the ranks' shapes
    group = init_distributed(init, world, rank, device="cuda:0", backend="gloo")
    try:
        with open(Path(tmp) / "inputs.pkl", "rb") as f:
            inp = pickle.load(f)
        cfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml"))
        out = {}
        t0 = time.perf_counter()
        for mode in ("pallas", "pallas_fused"):
            out[mode] = parallel_train(cfg, mode, inp["train"], group)
            if rank:
                out[mode]["grad"] = None  # rank 0's is the ranks' gradient
            else:
                out[mode]["grad"] = out[mode]["grad"].cpu()
        out["stage2"] = parallel_stage2(cfg, int(cfg.model.n_inp), inp["model_points"],
                                        inp["train"][0], group)
        out["train_seconds"] = time.perf_counter() - t0
        out["eval"] = parallel_eval(cfg, inp["model_points"], inp["bank"], inp["eval"],
                                    group)
        x = torch.ones(FLAT_GRAD_NUMEL, device=group.device)
        out["allreduce_ms"] = cuda_ms(lambda: dist.all_reduce(x), reps=10, warmup=2)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        destroy(group)


def run_parallel_ranks(tmp: str, world: int = PARALLEL_WORLD) -> list:
    """Start the ranks of phase 15 and wait for them: a rank that raises
    ends the others and fails the phase, as does PARALLEL_TIMEOUT (the
    ranks are then killed). Returns each rank's results."""
    import torch

    init = "file://" + str(Path(tmp) / "rendezvous")
    ctx = torch.multiprocessing.start_processes(
        _parallel_rank, args=(world, init, tmp), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.perf_counter() + PARALLEL_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            check(time.perf_counter() < deadline,
                  f"the ranks did not end within {PARALLEL_TIMEOUT:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def parallel_phase(card: str, cfg, samples, batches, bank, model_points,
                   entries: dict) -> None:
    """Phase 15 (the module docstring): (a) NCCL at world 1 through the
    port's init_distributed (world1_lockstep), (b) two gloo ranks on the
    one card against one process at the same global batch, (c) the Evaluator over the two ranks,
    (d) the times."""
    import pickle
    import tempfile

    import torch
    import torch.distributed as dist

    from dcl_net_tpu_torch.data.schema import make_batch
    from dcl_net_tpu_torch.parallel.mesh import destroy, init_distributed

    t_phase = time.perf_counter()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    print("parallel phase: cuDNN autotuning off (the ranks and this process), deterministic "
          "cuDNN for (a)", flush=True)
    train = [make_batch(samples[i * PARALLEL_BATCH:(i + 1) * PARALLEL_BATCH]).to_dict()
             for i in range(PARALLEL_STEPS)]
    evals = batches[:PARALLEL_EVAL_BATCHES]
    n_points = int(cfg.model.n_inp)
    totals = {k: 0 for k in KERNEL_ORDER}

    def add(counts):
        for k, n in counts.items():
            totals[k] += n

    with tempfile.TemporaryDirectory(prefix="dclx_parallel_") as tmp:
        # ---- (a) NCCL at world 1: the group's steps equal the steps without one
        t0 = time.perf_counter()
        group = init_distributed("file://" + str(Path(tmp) / "nccl"), 1, 0,
                                 device=torch.device("cuda", 0))
        try:
            check(group.backend == "nccl" and group.world == 1, f"group {group}")
            counts, grad_rel = world1_lockstep(cfg, train, group)
            add(counts)
            x = torch.ones(FLAT_GRAD_NUMEL, device="cuda")
            nccl_ms = cuda_ms(lambda: dist.all_reduce(x), reps=20, warmup=3)
        finally:
            destroy(group)
        t_a = time.perf_counter() - t0
        torch.backends.cudnn.deterministic = False
        print(f"parallel (a) NCCL at world 1 on {card}: {PARALLEL_STEPS} steps at batch "
              f"{PARALLEL_BATCH}, each from the state of the run without a group: losses and "
              f"BN statistics torch.equal, no collective issued, flat gradient rel L2 "
              f"{['%.3g' % r for r in grad_rel]} (the backward's run-to-run spread); "
              f"{t_a:.1f} s", flush=True)

        # ---- the single process's references of (b) and (c)
        t0 = time.perf_counter()
        ref = {mode: parallel_train(cfg, mode, train) for mode in ("pallas", "pallas_fused")}
        ref_s2 = parallel_stage2(cfg, n_points, model_points, train[0])
        ref_eval = parallel_eval(cfg, model_points, bank, evals)
        t_ref = time.perf_counter() - t0
        ref_seconds = {m: [s["seconds"] for s in ref[m]["steps"]] for m in ref}
        torch.cuda.empty_cache()

        # ---- (b), (c): two gloo ranks on the one card
        with open(Path(tmp) / "inputs.pkl", "wb") as f:
            pickle.dump({"train": train, "eval": evals, "bank": bank,
                         "model_points": model_points}, f)
        t0 = time.perf_counter()
        ranks = run_parallel_ranks(tmp)
        t_ranks = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = benchmark

    per_rank = {"pallas": TWO_STAGE_TRAIN, "pallas_fused": FUSED_TRAIN}
    for r, res in enumerate(ranks):
        for mode, per_step in per_rank.items():
            expect_counts(res[mode]["counts"], per_step, PARALLEL_STEPS,
                          f"rank {r} train ({mode})")
            check(res[mode]["same_params"], f"rank {r} ({mode}): the ranks' parameters "
                  "differ after a step")
            add(res[mode]["counts"])
        expect_counts(res["stage2"]["counts"], {"voxelize": 2, "compact": 8, "fused": 8}, 1,
                      f"rank {r} stage-2 step")
        add(res["stage2"]["counts"])
        expect_counts(res["eval"]["counts"], {"voxelize": 1, "compact": 4, "interp": 4},
                      1 + PARALLEL_EVAL_BATCHES, f"rank {r} eval")
        add(res["eval"]["counts"])
    for mode in per_rank:
        got, want = ranks[0][mode], ref[mode]
        loss_rel = max(abs(got["steps"][0]["metrics"][k] - want["steps"][0]["metrics"][k])
                       / abs(want["steps"][0]["metrics"][k])
                       for k in ("loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "loss_all"))
        grad_rel = float((got["grad"].to(want["grad"].device) - want["grad"]).norm()
                         / want["grad"].norm())
        later = max(abs(g["metrics"]["loss_all"] - w["metrics"]["loss_all"])
                    / abs(w["metrics"]["loss_all"])
                    for g, w in zip(got["steps"][1:], want["steps"][1:]))
        check(all(ranks[1][mode]["steps"][k]["metrics"] == got["steps"][k]["metrics"]
                  for k in range(PARALLEL_STEPS)), f"{mode}: the ranks' metrics differ")
        rank_s = [max(r[mode]["steps"][k]["seconds"] for r in ranks)
                  for k in range(PARALLEL_STEPS)]
        print(f"parallel (b) {mode}, 2 gloo ranks on {card} vs one process at global batch "
              f"{PARALLEL_BATCH}: step 1 losses rel {loss_rel:.3g}, flat gradient rel L2 "
              f"{grad_rel:.3g}; steps 2-{PARALLEL_STEPS} loss_all rel {later:.3g}; step "
              f"seconds 2 ranks {['%.4f' % t for t in rank_s]}, one process "
              f"{['%.4f' % t for t in ref_seconds[mode]]}", flush=True)
        check(loss_rel <= TRAIN_LOSS_RTOL, f"{mode}: step-1 losses differ by {loss_rel}")
        check(grad_rel <= TRAIN_GRAD_REL_L2, f"{mode}: step-1 gradient differs by {grad_rel}")
        check(later <= PARALLEL_LATER_RTOL, f"{mode}: later losses differ by {later}")
    s2_rel = max(abs(ranks[0]["stage2"]["metrics"][k] - ref_s2["metrics"][k])
                 / abs(ref_s2["metrics"][k]) for k in ("loss_all", "loss_last_iter"))
    print(f"parallel (b) stage-2 refiner step: losses rel {s2_rel:.3g}", flush=True)
    check(s2_rel <= TRAIN_LOSS_RTOL, f"stage-2 losses differ by {s2_rel}")
    for r, res in enumerate(ranks):
        check(res["eval"]["summary"] == ref_eval["summary"],
              f"rank {r} eval summary {res['eval']['summary']} != one process's "
              f"{ref_eval['summary']}")
    print(f"parallel (c) Evaluator over 2 ranks, {PARALLEL_EVAL_BATCHES} global batches of "
          f"{BATCH}: {ranks[0]['eval']['summary']} equal to one process's; "
          f"{max(r['eval']['seconds'] for r in ranks):.3f} s (one process "
          f"{ref_eval['seconds']:.3f} s)", flush=True)
    for key, n in totals.items():
        if n:
            entries[key]["parallel_launches"] = n
    gloo_ms = max(r["allreduce_ms"] for r in ranks)
    print(f"parallel (d) on {card}: one all-reduce of the flat gradient "
          f"({FLAT_GRAD_NUMEL} f32, {FLAT_GRAD_NUMEL * 4 / 1e6:.1f} MB): NCCL world 1 "
          f"{nccl_ms:.4f} ms, gloo world 2 (CUDA tensors) {gloo_ms:.4f} ms; seconds: (a) "
          f"{t_a:.1f}, one-process references {t_ref:.1f}, ranks (b, c, start-up included) "
          f"{t_ranks:.1f} (their training {max(r['train_seconds'] for r in ranks):.1f}); "
          f"launches {dict((k, n) for k, n in totals.items() if n)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- phase 16: the rest of the JAX package ---------------------------------------
LOCAL_EVAL = {"voxelize": 1}  # one K1 an encode on interp_mode "local": no K2, K3, K6
LOCAL_TRAIN = {"voxelize": 2}  # a train step encodes both branches
LOCAL_ATOL = 1e-5  # local vs exact where the exact 3 neighbours lie in the window
SHARDED_ATOL = 1e-5  # a sharded artifact against the single one (test_serving.py:171)
SURFACE_ATOL = 1e-4  # a module's card run against its CPU copy: matmuls in other orders
# K1's gradient is compared on the CPU for the first rows only: a row's
# gradient depends on that row alone, and the plain version takes seconds a
# case at batch 32 on the host
K1GRAD_CPU_ROWS = 2
FPS_POINTS, FPS_SAMPLES = 16384, 1024


def local_levels_check(model, tb) -> None:
    """Each level's local features against the exact path's, on the card, at
    the points whose exact 3 nearest occupied voxels all lie in the point's
    window (the samples that overflow a compaction capacity left out)."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_compact, cuda_interp
    from dcl_net_tpu_torch.ops.cuda_voxelize import voxelize_cuda
    from dcl_net_tpu_torch.ops.grid_interp import local_grid_interpolate
    from dcl_net_tpu_torch.ops.sparse_conv import voxel_centers

    pf = model.point_feats_inp
    feats, vidx = tb["inp"]["feats"], tb["inp"]["voxel_idx"]
    points = feats[..., 4:7].contiguous()
    half = pf.window // 2
    with torch.no_grad():
        grid, count = voxelize_cuda(feats, vidx, model.grid_shape, mode=model.voxelization_mode)
        pyramid = model.backbone_inp(grid, (count > 0).to(feats.dtype))
        for level, (f, m) in enumerate(pyramid):
            scale = pf.scale_list[level]
            local = local_grid_interpolate(points, f, m, pf.unit, scale, pf.offset, pf.window)
            dims = f.shape[1:4]
            cap = min(pf.capacities[level], int(dims[0] * dims[1] * dims[2]))
            coords, vfeats, vmask, occ = cuda_compact.dense_to_sparse_cuda(
                f.contiguous(), m.contiguous(), cap)
            centers = voxel_centers(coords, pf.unit, scale, pf.offset)
            exact, _, idx = cuda_interp.nn_interpolate_cuda(points, centers, vfeats, vmask, occ)
            # each point's quirk cell, clipped, as local_grid_interpolate takes it
            su = torch.as_tensor(pf.unit * float(scale), device=points.device)
            off = torch.as_tensor(pf.offset, device=points.device)
            hi = torch.tensor([d - 1 for d in dims], device=points.device)
            base = torch.minimum(torch.clamp(torch.floor((points - off) / su).long(), min=0), hi)
            nb = torch.gather(coords.long(), 1, idx.long().transpose(1, 2).reshape(
                idx.shape[0], -1, 1).expand(-1, -1, 3)).reshape(idx.shape[0], -1, 3, 3)
            inside = ((nb - base[:, :, None]).abs() <= half).all(-1).all(-1)   # [B, N]
            inside &= (occ <= cap)[:, None]
            share = float(inside.float().mean())
            err = float((local - exact).abs()[inside].max()) if inside.any() else 0.0
            print(f"local level {level} ({tuple(dims)}, scale {scale}): {share:.4%} of the "
                  f"points have their exact 3 neighbours in the window; local vs exact "
                  f"there: max abs {err:.3g}", flush=True)
            check(share > 0.5, f"level {level}: only {share:.2%} of the points comparable")
            check(err <= LOCAL_ATOL, f"level {level}: local differs from exact by {err}")


def timed_evaluate(model, model_points, bank, batches):
    """(summary, launch counts, seconds, peak GiB) of one counted Evaluator
    run after an uncounted warm-up batch."""
    import torch

    from dcl_net_tpu_torch.eval.evaluator import Evaluator

    Evaluator(model, model_points, template_bank=bank).evaluate(batches[:1])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = Evaluator(model, model_points, template_bank=bank).evaluate(batches)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, read_counts(), seconds, torch.cuda.max_memory_allocated() / 2 ** 30


def local_phase(card, cfg, batches, bank, model_points, entries) -> None:
    """Phase 16(a): interp_mode "local" in f32 and bf16 through Evaluator,
    its levels against the exact path, 2 rows against the CPU, 2 train
    steps through Solver."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.models.dcl_net import DCLNet

    mcfg = cfg.model
    rows = BATCH * len(batches)
    encodes = 1 + len(batches)
    _, _, t_exact, peak_exact = timed_evaluate(DCLNet.from_config(mcfg, seed=0), model_points,
                                               bank, batches)
    for dtype, key in ((None, "voxelize"), (torch.bfloat16, "voxelize_bf16")):
        name = "f32" if dtype is None else "bf16"
        model = DCLNet.from_config(mcfg, seed=0, interp_mode="local", dtype=dtype)
        res, launches, seconds, peak = timed_evaluate(model, model_points, bank, batches)
        print(f"local eval ({name}) launches {launches} over {encodes} encodes", flush=True)
        expect_counts(launches, {key: 1}, encodes, f"local eval ({name})")
        entries[key]["local_eval_launches"] = launches[key]
        entries[key]["launches"] = entries[key].get("launches", 0) + launches[key]
        check(res["n_scored"] == rows - 1, f"local n_scored {res['n_scored']}")
        check(res["n_overflow"] == 0, "the local path flagged an overflow")
        check(bool(np.isfinite(res["auc_mean"])), "local auc_mean is not finite")
        print(f"local eval ({name}) on {card}: evaluate {seconds:.3f} s for {rows} rows = "
              f"{rows / seconds:.1f} instances/s, peak memory {peak:.2f} GiB (exact f32 path "
              f"in this run: {rows / t_exact:.1f} instances/s, peak {peak_exact:.2f} GiB); "
              f"auc_mean {res['auc_mean']}", flush=True)
        tb = batch_to_torch(batches[1], torch.device("cuda"))
        with torch.no_grad():
            out = model(tb)
        check(bool(torch.isfinite(out["rot_pred"]).all()
                   and torch.isfinite(out["trans_pred"].float()).all()), "local: non-finite")
        if dtype is None:
            local_levels_check(model, tb)
            cpu = DCLNet.from_config(mcfg, seed=0, interp_mode="local", device="cpu")
            two = batch_to_torch(batches[1], torch.device("cpu"))
            two = {k: ({kk: vv[:2] for kk, vv in v.items()} if isinstance(v, dict) else v[:2])
                   for k, v in two.items()}
            with torch.no_grad():
                ref = cpu(two)
            e_rot = max_err(out["rot_pred"][:2].cpu(), ref["rot_pred"])
            e_trans = max_err(out["trans_pred"][:2].cpu(), ref["trans_pred"])
            print(f"local eval, 2 rows on the card vs the CPU: rot_pred {e_rot:.3g} "
                  f"trans_pred {e_trans:.3g}", flush=True)
            check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL, "local: card differs from CPU")
        del model
        torch.cuda.empty_cache()
    launches, solver, _, perf = train_phase(cfg, card, "local", steps=2, per_step=LOCAL_TRAIN)
    entries["voxelize"]["local_train_launches"] = launches["voxelize"]
    entries["voxelize"]["launches"] += launches["voxelize"]
    del solver
    torch.cuda.empty_cache()


def modes_phase(card, cfg, batches, entries) -> None:
    """Phase 16(b): voxelization modes 0-2 at the main batch."""
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.ops.cuda_voxelize import voxelize_cuda
    from dcl_net_tpu_torch.ops.voxelize import voxelize_dense

    mcfg = cfg.model
    tb = batch_to_torch(batches[0], torch.device("cuda"))
    feats, vidx = tb["inp"]["feats"], tb["inp"]["voxel_idx"]
    grid_shape = tuple(int(d) for d in mcfg.voxel_num_limit)
    # mode 0 is K1's sum (the model launches it at mode 3): bit-equal to the
    # plain mode-0 sum on the CPU
    g3, c3 = voxelize_cuda(feats, vidx, grid_shape, mode=3)
    g0, c0 = voxelize_dense(feats.cpu(), vidx.cpu(), grid_shape, mode=0)
    check(torch.equal(g3.cpu(), g0) and torch.equal(c3.cpu(), c0),
          "K1's sum differs from the CPU's mode 0")
    for mode in (1, 2):
        t0 = time.perf_counter()
        g, c = voxelize_dense(feats, vidx, grid_shape, mode=mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gc, cc = voxelize_dense(feats.cpu(), vidx.cpu(), grid_shape, mode=mode)
        check(torch.equal(g.cpu(), gc) and torch.equal(c.cpu(), cc),
              f"mode {mode}: the card differs from the CPU")
        print(f"voxelization mode {mode} at batch {BATCH}: equal to the CPU run "
              f"({ms:.2f} ms on the card, first call)", flush=True)
    with torch.no_grad():
        ref = DCLNet.from_config(mcfg, seed=0, voxelization_mode=3)(tb)
        for mode, per_run in ((0, {"voxelize": 2}), (1, {}), (2, {})):
            model = DCLNet.from_config(mcfg, seed=0, voxelization_mode=mode)
            reset_counts()
            out = model(tb)
            torch.cuda.synchronize()
            launches = read_counts()
            # both branches, each compacted (K2) and interpolated (K3) at 4 levels
            expect_counts(launches, {**per_run, "compact": 8, "interp": 8},
                          1, f"mode {mode} forward")
            check(bool(torch.isfinite(out["rot_pred"]).all()
                       and torch.isfinite(out["trans_pred"]).all()), f"mode {mode}: non-finite")
            if mode == 0:
                entries["voxelize"]["mode0_launches"] = launches["voxelize"]
                entries["voxelize"]["launches"] = (entries["voxelize"].get("launches", 0)
                                                   + launches["voxelize"])
            same = mode == 0 and all(torch.equal(out[k], ref[k]) for k in ("rot_pred",
                                                                           "trans_pred"))
            print(f"voxelization mode {mode}: one forward of batch {BATCH}, launches "
                  f"{dict((k, n) for k, n in launches.items() if n)}"
                  + (f", poses torch.equal to mode 3: {same}" if mode == 0 else ""), flush=True)
            check(mode != 0 or same, "a mode-0 model differs from the mode-3 model")


def _sharded_rank(rank: int, world: int, init: str, tmp: str) -> None:
    """One rank of phase 16(c): gloo on cuda:0 serves the global batch through
    the data-parallel artifact; leaves its outputs and launches in tmp."""
    import pickle

    import torch

    sys.path.insert(0, str(ROOT))
    from dcl_net_tpu_torch import serving, strict_f32
    from dcl_net_tpu_torch.parallel.mesh import destroy, init_distributed

    strict_f32()
    torch.backends.cudnn.benchmark = False
    group = init_distributed(init, world, rank, device="cuda:0", backend="gloo")
    try:
        with open(Path(tmp) / "inputs.pkl", "rb") as f:
            inp = pickle.load(f)
        module = serving.load_serve(Path(tmp) / "sharded.pt2", group=group)
        req = [x.to("cuda:0") for x in inp["request"]]
        with torch.inference_mode():
            module(*req)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            out = module(*req)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        torch.save({"out": {k: v.cpu() for k, v in out.items()}, "launches": read_counts(),
                    "seconds": seconds}, Path(tmp) / f"rank{rank}.pt")
    finally:
        destroy(group)


def sharded_phase(card, model, bank, batches, entries) -> None:
    """Phase 16(c): the data-parallel serving artifact against the single
    artifact: one exported on the CPU and served on the card by an NCCL
    group of one rank, and one served by two gloo ranks sharing the card.
    (NCCL takes one rank a GPU: scripts/serve_sharded_multi_gpu.py serves
    over NCCL across GPUs.)"""
    import copy
    import pickle
    import tempfile

    import torch

    from dcl_net_tpu_torch import serving
    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.parallel.mesh import destroy, init_distributed

    n_points = int(batches[0]["inp"]["feats"].shape[1])
    tb = batch_to_torch(batches[0], torch.device("cuda"))
    req = (tb["inp"]["feats"], tb["inp"]["voxel_idx"], tb["labels"]["obj_idx"].to(torch.int32))
    single = serving.export_serve(model, bank, BATCH, n_points)
    with torch.inference_mode():
        want = serving.load_serve(single)(*req)

    def compare(what, got):
        errs = {k: max_err(got[k].float().cpu(), want[k].float().cpu()) for k in want}
        same = all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want)
        print(f"sharded artifact ({what}) vs the single artifact at batch {BATCH} on {card}: "
              f"max abs {max(errs.values()):.3g} (torch.equal {same})", flush=True)
        check(max(errs.values()) <= SHARDED_ATOL, f"sharded artifact ({what}) differs: {errs}")

    with tempfile.TemporaryDirectory(prefix="dclx_sharded_") as tmp:
        group = init_distributed("file://" + str(Path(tmp) / "nccl"), 1, 0,
                                 device=torch.device("cuda", 0))
        try:
            check(group.backend == "nccl", f"group {group}")
            # exported on the CPU (CPU copies of the model and of the card's
            # template cache), served on the card through ShardedServe:
            # load_serve moves the program to the group's device
            cache = serving.encode_template_cache(model, bank)
            on_cpu = serving._export(serving.make_serve_fn(
                copy.deepcopy(model).cpu(), {k: v.cpu() for k, v in cache.items()}),
                BATCH, n_points)
            served = serving.load_serve(on_cpu, group=group)
            check(isinstance(served, serving.ShardedServe), "no ShardedServe for a group")
            state = list(served.module.parameters()) + list(served.module.buffers())
            check(all(t.device == group.device for t in state),
                  "the CPU-exported artifact kept weights off the group's device")
            with torch.inference_mode():
                reset_counts()
                got = served(*req)
                expect_counts(read_counts(), {"voxelize": 1, "compact": 4, "interp": 4}, 1,
                              "the CPU-exported artifact on the card")
            compare("exported on the CPU, served on the card, NCCL world 1", got)
        finally:
            destroy(group)
        with open(Path(tmp) / "sharded.pt2", "wb") as f:
            f.write(serving.export_serve(model, bank, BATCH, n_points, world=PARALLEL_WORLD))
        with open(Path(tmp) / "inputs.pkl", "wb") as f:
            pickle.dump({"request": [x.cpu() for x in req]}, f)
        init = "file://" + str(Path(tmp) / "rendezvous")
        ctx = torch.multiprocessing.start_processes(
            _sharded_rank, args=(PARALLEL_WORLD, init, tmp), nprocs=PARALLEL_WORLD,
            join=False, start_method="spawn")
        deadline = time.perf_counter() + PARALLEL_TIMEOUT
        try:
            while not ctx.join(timeout=1.0):
                check(time.perf_counter() < deadline, "the serving ranks did not end")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        for r in range(PARALLEL_WORLD):
            res = torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
            compare(f"gloo rank {r} of {PARALLEL_WORLD}", res["out"])
            # each rank encodes its half: one K1, 4 K2 and 4 K3
            expect_counts(res["launches"], {"voxelize": 1, "compact": 4, "interp": 4}, 1,
                          f"sharded rank {r}")
            print(f"sharded rank {r}: {res['seconds'] * 1e3:.1f} ms for the global batch "
                  f"(its {BATCH // PARALLEL_WORLD} rows and the gather)", flush=True)


def surface_phase(card) -> None:
    """Phase 16(d): the library surface on the card against CPU copies."""
    import importlib

    import torch

    from dcl_net_tpu_torch.ops import extras, pointnet_modules as pm, sparse_conv as sc

    knn = importlib.import_module("dcl_net_tpu_torch.ops.knn")  # ops.knn is the function
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(16)
    xyz = torch.rand((2, FPS_POINTS, 3), generator=gen) * 0.3
    pf = torch.randn((2, FPS_POINTS, 3), generator=gen)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    idx, ms = timed(lambda: knn.furthest_point_sample(xyz.to(dev), FPS_SAMPLES))
    ref = knn.furthest_point_sample(xyz, FPS_SAMPLES)
    check(torch.equal(idx.cpu(), ref), "FPS differs from its CPU run")
    print(f"FPS {FPS_POINTS} -> {FPS_SAMPLES} at batch 2 on {card}: {ms:.1f} ms, equal to "
          f"the CPU run", flush=True)
    centers = knn.gather_operation(xyz, ref.long())
    radius, nsample = 0.02, 32
    ball, ms = timed(lambda: knn.ball_query(radius, nsample, xyz.to(dev), centers.to(dev)))
    ball_ref = knn.ball_query(radius, nsample, xyz, centers)
    # the expansion form |a|^2 - 2ab + |b|^2 rounds its cancellation other
    # ways on the card (about 1e-8 here): rows with a point within 1e-3 r^2
    # of the radius may differ, no other
    d2 = ((centers[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    near = ((d2 - radius ** 2).abs() < 1e-3 * radius ** 2).any(-1)
    del d2
    same = (ball.cpu() == ball_ref).all(-1)
    check(bool((same | near).all()), "ball query differs away from the radius")
    print(f"ball query r {radius} k {nsample} of {FPS_SAMPLES} centers: {ms:.1f} ms, "
          f"{int(same.sum())} of {same.numel()} rows equal to the CPU run ({int(near.sum())} "
          f"near the radius)", flush=True)
    grouped = knn.grouping_operation(pf.to(dev), ball_ref.to(dev))
    check(torch.equal(grouped.cpu(), knn.grouping_operation(pf, ball_ref)), "grouping differs")

    def module_pair(make):
        torch.manual_seed(0)
        return make("cuda"), make("cpu")

    radii, nsamples = [0.02, 0.04], [16, 32]
    sa, sa_cpu = module_pair(lambda d: pm.PointnetSAModuleMSG(
        FPS_SAMPLES, radii, nsamples, [[32, 64], [64, 128]], in_channels=3, device=d))
    with torch.no_grad():
        (new_xyz, new_f), ms = timed(lambda: sa(xyz.to(dev), pf.to(dev)))
        new_xyz_c, new_f_c = sa_cpu(xyz, pf)
    check(torch.equal(new_xyz.cpu(), new_xyz_c), "SA-MSG centers differ")
    # compared on the centers whose balls are the same on both (see above)
    rows = torch.ones(new_f_c.shape[:2], dtype=torch.bool)
    for r, k in zip(radii, nsamples):
        rows &= (knn.ball_query(r, k, xyz.to(dev), new_xyz).cpu()
                 == knn.ball_query(r, k, xyz, new_xyz_c)).all(-1)
    e_sa = max_err(new_f.cpu()[rows], new_f_c[rows])
    fp, fp_cpu = module_pair(lambda d: pm.PointnetFPModule([128, 64], in_channels=192 + 3,
                                                           device=d))
    with torch.no_grad():  # the same known features on both
        out, ms_fp = timed(lambda: fp(xyz.to(dev), new_xyz, pf.to(dev), new_f_c.to(dev)))
        out_c = fp_cpu(xyz, new_xyz_c, pf, new_f_c)
    same_nn = (knn.three_nn(xyz.to(dev), new_xyz)[1].cpu()
               == knn.three_nn(xyz, new_xyz_c)[1]).all(-1)
    e_fp = max_err(out.cpu()[same_nn], out_c[same_nn])
    print(f"SA-MSG ({FPS_POINTS} -> {FPS_SAMPLES}, 2 scales) {ms:.1f} ms, max abs vs CPU "
          f"{e_sa:.3g} on the {float(rows.float().mean()):.4%} of centers with equal balls; "
          f"FP ({FPS_SAMPLES} -> {FPS_POINTS}) {ms_fp:.1f} ms, max abs vs CPU {e_fp:.3g} on "
          f"the {float(same_nn.float().mean()):.4%} of points with equal 3-NN", flush=True)
    check(float(rows.float().mean()) > 0.99 and float(same_nn.float().mean()) > 0.99,
          "the card's neighbourhoods differ from the CPU's beyond rounding")
    check(e_sa <= SURFACE_ATOL and e_fp <= SURFACE_ATOL, "a PointNet++ module differs")

    d = 64
    mask = (torch.rand((2, d, d, d), generator=gen) < 0.05).float()
    grid = torch.randint(-3, 4, (2, d, d, d, 16), generator=gen).float() * mask[..., None]
    dout = torch.randn((2, d // 2, d // 2, d // 2, 16), generator=gen)
    outs = []
    for g in (grid.to(dev).requires_grad_(True), grid.detach().clone().requires_grad_(True)):
        pooled, pmask = sc.sparse_max_pool(g, mask.to(g.device))
        (pooled * dout.to(g.device)).sum().backward()
        outs.append((pooled.detach().cpu(), pmask.cpu(), g.grad.cpu()))
    check(all(torch.equal(a, b) for a, b in zip(*outs)), "sparse max pool differs")
    print(f"sparse max pool on {d}^3 x 16 at batch 2 (ties everywhere): forward and "
          f"gradient equal to the CPU run", flush=True)
    small = grid[:, ::2, ::2, ::2].contiguous()
    smask = mask[:, ::2, ::2, ::2].contiguous()
    w = torch.randn((3, 3, 3, 16, 16), generator=gen) * 0.1
    t, tm = sc.sparse_conv_transpose(small.to(dev), smask.to(dev), w.to(dev))
    t_c, tm_c = sc.sparse_conv_transpose(small, smask, w)
    inv, _ = sc.sparse_inverse_conv(small.to(dev), smask.to(dev), w.to(dev), mask.to(dev))
    inv_c, _ = sc.sparse_inverse_conv(small, smask, w, mask)
    e_t, e_i = max_err(t.cpu(), t_c), max_err(inv.cpu(), inv_c)
    check(torch.equal(tm.cpu(), tm_c), "transposed conv mask differs")
    check(e_t <= SURFACE_ATOL and e_i <= SURFACE_ATOL, f"transposed convs differ {e_t} {e_i}")
    fields = torch.randn((2, 32, 32, 32, 4, 3), generator=gen)
    fmask = (torch.rand((2, 32, 32, 32), generator=gen) < 0.2).float()
    fo = extras.sparse_field_max_pool(fields.to(dev), fmask.to(dev))
    fo_c = extras.sparse_field_max_pool(fields, fmask)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(fo, fo_c)), "field max pool differs")
    print(f"transposed conv {tuple(small.shape[1:4])} -> {tuple(t.shape[1:4])} max abs vs "
          f"CPU {e_t:.3g}, inverse conv onto {d}^3 {e_i:.3g}; field max pool equal to the "
          f"CPU run", flush=True)


def k1_grad_phase(card, batch, grid_shape) -> None:
    """Phase 16(e): K1's backward on the card (the module docstring)."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_voxelize

    dev = torch.device("cuda")
    feats, vidx = batch["inp"]["feats"].to(dev), batch["inp"]["voxel_idx"].to(dev)
    b, n, c = feats.shape
    gen = torch.Generator().manual_seed(61)
    mask = (torch.rand((b, n), generator=gen) > 0.3).float().to(dev)
    g = torch.randn((b, *grid_shape, c), generator=gen).to(dev)
    rows = K1GRAD_CPU_ROWS
    cases = []
    for mode in (3, 4):
        for m in (None, mask):
            for out in (None, torch.bfloat16):
                what = (f"K1 gradient mode {mode}, {'mask' if m is not None else 'no mask'}, "
                        f"{'bf16' if out else 'f32'} grid")
                cot = g.to(out or torch.float32)
                f = feats.clone().requires_grad_(True)
                reset_counts()
                grid, _ = cuda_voxelize.voxelize_cuda(f, vidx, grid_shape, mode, m, out)
                launched = read_counts()
                check(launched["voxelize_bf16" if out else "voxelize"] == 1
                      and sum(launched.values()) == 1, f"{what}: launches {launched}")
                (got,) = torch.autograd.grad(grid, f, cot)
                check(got.is_cuda and got.dtype == torch.float32 and bool(got.abs().sum() > 0),
                      f"{what}: gradient {got.dtype} on {got.device}")
                fc = feats[:rows].cpu().requires_grad_(True)
                gc, _ = cuda_voxelize.voxelize_cuda(fc, vidx[:rows].cpu(), grid_shape, mode,
                                                    None if m is None else m[:rows].cpu(), out)
                (cpu,) = torch.autograd.grad(gc, fc, cot[:rows].cpu())
                check(torch.equal(got[:rows].cpu(), cpu), f"{what}: differs from the CPU's")
                fp = feats.clone().requires_grad_(True)
                gp, _ = cuda_voxelize.voxelize_reference(fp, vidx, grid_shape, mode, m, out)
                (plain,) = torch.autograd.grad(gp, fp, cot)
                want = got if out is None else got.to(torch.bfloat16).float()
                check(torch.equal(want, plain),
                      f"{what}: differs from the plain version's gradient by "
                      f"{max_err(want, plain)}")
                cases.append(what.removeprefix("K1 gradient "))
    print(f"K1 gradient on {card} at batch {b} ({n} points, {c} features, "
          f"{'x'.join(map(str, grid_shape))} grid): {len(cases)} cases ({'; '.join(cases)}) "
          f"torch.equal to the CPU's ({rows} rows) and to the plain version's on the card",
          flush=True)


def rest_phase(card, cfg, batches, bank, model_points, entries) -> None:
    """Phase 16 (the module docstring): (a) local, (b) modes, (c) the sharded
    artifact, (d) the library surface, (e) K1's backward."""
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch
    from dcl_net_tpu_torch.models.dcl_net import DCLNet

    t_phase = time.perf_counter()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        t0 = time.perf_counter()
        local_phase(card, cfg, batches, bank, model_points, entries)
        torch.backends.cudnn.benchmark = False  # Solver turned it on
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        modes_phase(card, cfg, batches, entries)
        t_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        sharded_phase(card, DCLNet.from_config(cfg.model, seed=0), bank, batches, entries)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        surface_phase(card)
        t_d = time.perf_counter() - t0
        t0 = time.perf_counter()
        k1_grad_phase(card, batch_to_torch(batches[0], torch.device("cuda")),
                      tuple(int(d) for d in cfg.model.voxel_num_limit))
        t_e = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.benchmark = benchmark
    print(f"rest-of-package phase: (a) {t_a:.1f} s (b) {t_b:.1f} s (c) {t_c:.1f} s "
          f"(d) {t_d:.1f} s (e) {t_e:.1f} s; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---- phase 17: the last departures from the JAX package --------------------------
LARGE_VOX_POINTS = (8192, 16384)  # (a): K1 past its in-tile list (about 6,200 at C = 7)
LARGE_VOX_BATCH = 8
LARGE_VOX_HOT = 5000  # (a): points of one cell of sample 0, across K1's rounds
LARGE_BWD_POINTS = (4096, 8192)  # (b): K4 and K7 past one sorting block (2048)
LARGE_BWD_CHANNELS = (256, 512)  # (b): the writers past one pass of 256 channels
LARGE_BWD_BATCH = 4
LARGE_BWD_GRID = (16, 16, 16)  # (b): K7's grid, of the 16^3 level's capacity 1024
LARGE_BWD_CAP = 1024
LARGE_TRAIN_POINTS, LARGE_TRAIN_BATCH = 4096, 8  # (c): n_inp = n_tmp of two train steps
LARGE_EVAL_POINTS, LARGE_EVAL_ROWS = 8192, 2  # (c): n_inp = n_tmp of an Evaluator
PIPELINE_BATCHES = 4  # (d)
PROFILE_BATCH, PROFILE_STEPS = 4, 6  # (e): a Solver epoch, steps 2-4 traced
# (e): a name each of K1-K5's kernels has in the trace (csrc/*.cu)
PROFILE_KERNELS = (("K1", "voxelize_tiles"), ("K2", "compact_write"),
                   ("K3", "three_nn_rows"), ("K4", "interp_rows_bwd"),
                   ("K5", "compact_occupied_bwd"))


def large_voxelize_check(card, grid_shape, entries) -> None:
    """Phase 17(a): K1 at N = LARGE_VOX_POINTS, C = 7, through the rounds
    kernel (cuda_voxelize.plan): modes 3 and 4, with and without a point
    mask, f32 and bf16 grids, torch.equal to the plain version on the card;
    sample 0 in one tile with LARGE_VOX_HOT points of one cell spread over
    the point order (its sum carried across rounds), sample 1 with a hot
    last cell, the rest at random with points outside the grid. Mode 4
    timed on the device, f32 and bf16 grids, beside its byte bound."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_voxelize

    dev = torch.device("cuda")
    d0, d1, d2 = grid_shape
    gen = torch.Generator().manual_seed(171)
    b, c = LARGE_VOX_BATCH, 7
    timings = {}
    for n in LARGE_VOX_POINTS:
        vidx = torch.stack([torch.randint(-1, d + 1, (b, n), generator=gen)
                            for d in grid_shape], -1).int()
        vidx[0, :, 0] = 0  # sample 0: one tile of the grid's first cells
        vidx[0, :, 1] = torch.randint(0, min(d1, cuda_voxelize.TILE // d2), (n,), generator=gen)
        vidx[0, :, 2] = torch.randint(0, d2, (n,), generator=gen)
        hot = torch.randperm(n, generator=gen)[:LARGE_VOX_HOT]
        vidx[0, hot] = torch.tensor([0, 3, 5], dtype=torch.int32)
        # sample 1: its first LARGE_VOX_HOT // 2 points in the grid's last cell
        vidx[1, :LARGE_VOX_HOT // 2] = torch.tensor([d0 - 1, d1 - 1, d2 - 1],
                                                     dtype=torch.int32)
        scale = 10.0 ** torch.randint(-3, 4, (b, n, 1), generator=gen).float()
        feats = (torch.randn((b, n, c), generator=gen) * scale).to(dev)
        vidx = vidx.to(dev)
        mask = (torch.rand((b, n), generator=gen) > 0.2).float().to(dev)
        p = cuda_voxelize.plan(n, c)
        check(p.round_len > 0, f"K1 at N = {n}: the planner kept the list kernel")
        cases = 0
        for mode in (3, 4):
            for m in (None, mask):
                for out in (None, torch.bfloat16):
                    what = (f"K1 at N = {n} mode {mode} {'mask' if m is not None else 'no mask'}"
                            f" {'bf16' if out else 'f32'}")
                    grid, count = cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, mode, m,
                                                              out)
                    want, want_c = cuda_voxelize.voxelize_reference(feats, vidx, grid_shape,
                                                                    mode, m, out)
                    check(torch.equal(count, want_c), f"{what}: counts differ")
                    check(m is not None or int(count[0].max()) >= LARGE_VOX_HOT,
                          f"{what}: the hot cell lost points")
                    check(torch.equal(grid, want),
                          f"{what}: grid differs by {max_err(grid.float(), want.float())}")
                    cases += 1

        g = d0 * d1 * d2
        for key, out, size in (("voxelize", None, 4), ("voxelize_bf16", torch.bfloat16, 2)):
            dev_ms = graph_ms(lambda: cuda_voxelize.voxelize_cuda(feats, vidx, grid_shape, 4,
                                                                  None, out))
            # features, indices read once; the grid and the counts written once
            bms, bby = bound(b * n * (c * 4 + 12) + b * g * (c * size + 4), b * n * c * 2)
            timings.setdefault(key, {})[f"[{b}, {n}, {c}]"] = dict(
                device_ms=dev_ms, bound_ms=bms, bound_by=bby)
            print(f"K1 ({key}) at [{b}, {n}, {c}] on {card}: {cases} cases torch.equal to "
                  f"the plain version (rounds kernel: tile {p.tile}, {p.round_len} entries a "
                  f"round, {p.smem} B shared); mode 4 device {dev_ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({bby})", flush=True)
    for key, t in timings.items():
        entries[key]["large_n"] = t


def k2_layout(b: int, cap: int, grid_shape, gen):
    """coords [b, cap, 3] int32 and vmask [b, cap] f32 in K2's layout: a
    valid prefix of rising linear indices (occupancies from cap / 2 to cap),
    zeros past it; and the occupancies."""
    import torch

    d0, d1, d2 = grid_shape
    coords = torch.zeros((b, cap, 3), dtype=torch.int32)
    vmask = torch.zeros((b, cap))
    occ = torch.randint(cap // 2, cap + 1, (b,), generator=gen)
    for i in range(b):
        k = int(occ[i])
        lin = torch.sort(torch.randperm(d0 * d1 * d2, generator=gen)[:k]).values
        coords[i, :k] = torch.stack([lin // (d1 * d2), (lin // d2) % d1, lin % d2], -1).int()
        vmask[i, :k] = 1.0
    return coords, vmask, occ


def large_bwd_check(card, entries) -> None:
    """Phase 17(b): K4 and K7 at N = LARGE_BWD_POINTS and C =
    LARGE_BWD_CHANNELS, f32 and bf16 cotangents: bit-equal to their plain
    versions on CPU copies and from launch to launch, their inverse index
    (the counting sort over chunks) bit-equal to its plain version; sample 0's
    3N contributions all on slot 0. Each timed on the device at every shape
    in f32 and at the largest in bf16, beside its byte bound."""
    import torch

    from dcl_net_tpu_torch.ops import cuda_fused, cuda_interp

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(172)
    b, cap = LARGE_BWD_BATCH, LARGE_BWD_CAP
    coords, vmask, occ = k2_layout(b, cap, LARGE_BWD_GRID, gen)
    coords, vmask = coords.to(dev), vmask.to(dev)
    timings = {}
    cases = []
    for n in LARGE_BWD_POINTS:
        idx = (torch.rand((b, 3, n), generator=gen) * occ[:, None, None]).int()
        idx[0] = 0  # every contribution of sample 0 on one slot
        idx = idx.to(dev)
        w = torch.rand((b, 3, n), generator=gen).to(dev)
        check_inverse_index(idx, cap, f"inverse index at N = {n}")
        for c in LARGE_BWD_CHANNELS:
            scale = 10.0 ** torch.randint(-3, 4, (b, n, 1), generator=gen).float()
            g32 = (torch.randn((b, n, c), generator=gen) * scale).to(dev)
            for g in (g32, g32.to(torch.bfloat16)):
                tag = f"N = {n} C = {c} {'bf16' if g.dtype == torch.bfloat16 else 'f32'}"
                bit_equal_on_cpu(cuda_interp.nn_interpolate_bwd_cuda,
                                 cuda_interp.nn_interpolate_bwd_reference,
                                 (g, w, idx, cap), f"K4 at {tag}")
                bit_equal_on_cpu(cuda_fused.compact_interpolate_bwd_cuda,
                                 cuda_fused.compact_interpolate_bwd_reference,
                                 (g, w, idx, coords, vmask, LARGE_BWD_GRID), f"K7 at {tag}")
                cases.append(tag)
            shape = f"[{b}, {n}, {c}]"
            cells = LARGE_BWD_GRID[0] * LARGE_BWD_GRID[1] * LARGE_BWD_GRID[2]
            # bf16 timed at the largest shape only
            last = (n, c) == (LARGE_BWD_POINTS[-1], LARGE_BWD_CHANNELS[-1])
            for tag, g in (("", g32), ("_bf16", g32.to(torch.bfloat16)))[:2 if last else 1]:
                size = g.element_size()
                ins = b * n * c * size + b * 3 * n * 8  # g, w and idx read once
                k4_ms = graph_ms(lambda: cuda_interp.nn_interpolate_bwd_cuda(g, w, idx, cap))
                bms, bby = bound(ins + b * cap * c * size, b * 3 * n * c * 2)
                timings.setdefault("interp_bwd" + tag, {})[shape] = dict(
                    device_ms=k4_ms, bound_ms=bms, bound_by=bby)
                k7_ms = graph_ms(lambda: cuda_fused.compact_interpolate_bwd_cuda(
                    g, w, idx, coords, vmask, LARGE_BWD_GRID))
                b7, b7by = bound(ins + b * cap * 16 + b * cells * c * size, b * 3 * n * c * 2)
                timings.setdefault("fused_bwd" + tag, {})[shape] = dict(
                    device_ms=k7_ms, bound_ms=b7, bound_by=b7by)
                print(f"K4 / K7 {'bf16' if tag else 'f32'} at {shape} (cap {cap}, "
                      f"{LARGE_BWD_GRID[0]}^3 grid) on {card}: device {k4_ms:.4f} / "
                      f"{k7_ms:.4f} ms, bound {bms:.4f} / {b7:.4f} ms", flush=True)
    for key, t in timings.items():
        entries[key]["large_n"] = t
    print(f"K4 and K7 bit-equal to their plain versions on CPU copies, launch to launch, "
          f"at {len(cases)} shapes ({'; '.join(cases)}); the inverse index at N = "
          f"{', '.join(map(str, LARGE_BWD_POINTS))} bit-equal to its plain version",
          flush=True)


def large_model_check(card, cfg, entries) -> None:
    """Phase 17(c): the model at n_inp = n_tmp = LARGE_TRAIN_POINTS, one
    two-stage and one fused train pass at batch LARGE_TRAIN_BATCH (the
    launches of one pass, finite losses and gradient, the losses within
    TRAIN_LOSS_RTOL of the same pass on a CPU copy, the two-stage one, which
    the fused one equals on the CPU), then Evaluator at
    n_inp = LARGE_EVAL_POINTS on LARGE_EVAL_ROWS rows, its poses within
    POSE_ATOL of the CPU's."""
    import numpy as np
    import torch

    from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.eval.evaluator import Evaluator
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses

    dev, cpu = torch.device("cuda"), torch.device("cpu")

    def data(n, rows):
        mcfg = cfg.merge({"model": {"n_inp": n, "n_tmp": n}}).model
        ds = SyntheticPoseDataset(n_objects=N_CLASSES, n_points=n,
                                  unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
                                  voxel_num_limit=tuple(int(d) for d in mcfg.voxel_num_limit),
                                  seed=0)
        return mcfg, ds, make_batch([ds[i] for i in range(rows)]).to_dict()

    mcfg, _, batch = data(LARGE_TRAIN_POINTS, LARGE_TRAIN_BATCH)
    tb, tc = batch_to_torch(batch, dev), batch_to_torch(batch, cpu)
    # one CPU pass serves both paths: on the CPU the fused op's plain version
    # is K2 -> centers -> K3's, bit for bit
    ref = DCLNet.from_config(mcfg, seed=0, interp_mode="pallas", device=cpu).train()
    with torch.no_grad():
        want = {k: float(v) for k, v in dcl_losses(ref(tc), tc).items()}
    del ref
    launches = {}
    for mode, per_pass in (("pallas", TWO_STAGE_TRAIN), ("pallas_fused", FUSED_TRAIN)):
        model = DCLNet.from_config(mcfg, seed=0, interp_mode=mode)
        reset_counts()
        losses, grad = train_pass(model, tb)
        counts = read_counts()
        expect_counts(counts, per_pass, 1, f"n_inp {LARGE_TRAIN_POINTS} train pass ({mode})")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        check(all(np.isfinite(v) for v in losses.values())
              and bool(torch.isfinite(grad).all()), f"{mode}: non-finite train pass")
        rel = max(abs(losses[k] - want[k]) / abs(want[k]) for k in want)
        print(f"n_inp {LARGE_TRAIN_POINTS} train pass ({mode}) at batch {LARGE_TRAIN_BATCH} "
              f"on {card}: loss_all {losses['loss_all']:.6f}, losses rel {rel:.3g} from the "
              f"CPU's, gradient norm {float(grad.norm()):.4g}", flush=True)
        check(rel <= TRAIN_LOSS_RTOL, f"{mode}: losses differ from the CPU's by {rel}")
        del model
    mcfg, ds, batch = data(LARGE_EVAL_POINTS, LARGE_EVAL_ROWS)
    bank = ds.template_bank()
    points = np.stack([ds.model_points(c, MODEL_POINTS) for c in range(N_CLASSES)])
    reset_counts()
    ev = Evaluator(DCLNet.from_config(mcfg, seed=0), points, template_bank=bank)
    res = ev.evaluate([batch])
    counts = read_counts()
    # the template bank once, then the batch
    expect_counts(counts, {"voxelize": 1, "compact": 4, "interp": 4}, 2,
                  f"n_inp {LARGE_EVAL_POINTS} Evaluator")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    check(bool(np.isfinite(res["auc_mean"])), "n_inp 8192: auc_mean is not finite")
    got = ev._run(batch_to_torch(batch, dev))
    ref = Evaluator(DCLNet.from_config(mcfg, seed=0, device=cpu), points, template_bank=bank,
                    device=cpu)._run(batch_to_torch(batch, cpu))
    e_rot = max_err(got["rot_pred"].cpu(), ref["rot_pred"])
    e_trans = max_err(got["trans_pred"].cpu(), ref["trans_pred"])
    print(f"n_inp {LARGE_EVAL_POINTS} Evaluator on {card}, {LARGE_EVAL_ROWS} rows: launches "
          f"{dict((k, v) for k, v in counts.items() if v)}, vs the CPU rot_pred {e_rot:.3g} "
          f"trans_pred {e_trans:.3g}", flush=True)
    check(e_rot <= POSE_ATOL and e_trans <= POSE_ATOL, "n_inp 8192: card differs from CPU")
    for k, v in launches.items():
        if v:
            entries[k]["large_n_launches"] = v


def pipelined_eval_check(card, model, model_b, batches, bank, model_points) -> None:
    """Phase 17(d): the eval path's sync-free rotation projection
    (geometry/rotation.py::nearest_rotation) against the SVD's in f64; then
    Evaluator pipelined against strict order (each batch's device-to-host
    copy waited for as it is dispatched) on
    PIPELINE_BATCHES batches, f32 and bf16: the per-row distances and the
    summary torch.equal; batch i + 1 dispatched before batch i is fetched,
    the last batch fetched after the loop; one host sync while a batch is
    dispatched, the eval backbone's read of its rulebook's sizes
    (models/backbone.py; torch.cuda.set_sync_debug_mode("warn"), counted);
    two device-to-host copies a batch, that read and the rows
    (torch.profiler's Memcpy DtoH); instances/s of both, with no claim."""
    import warnings

    import numpy as np
    import torch

    from dcl_net_tpu_torch.eval.evaluator import Evaluator

    from dcl_net_tpu_torch.geometry.rotation import nearest_rotation

    # the eval path's sync-free projection against torch.linalg.svd's, both
    # in f64 on the card: the same matrices to f64 round-off, cast to f32
    gen = torch.Generator().manual_seed(174)
    m = torch.randn((BATCH * REPEAT, 3, 3), generator=gen, dtype=torch.float64).cuda()
    m = m / m.norm(dim=1, keepdim=True)  # unit columns, as the 9D head gives them
    u, _, vh = torch.linalg.svd(m)
    det = torch.linalg.det(u @ vh)
    want = (u * torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)[:, None]) @ vh
    e_proj = max_err(nearest_rotation(m), want)
    check(e_proj <= 1e-12, f"nearest_rotation differs from the SVD projection by {e_proj}")
    run = batches[:PIPELINE_BATCHES]
    rows = PIPELINE_BATCHES * BATCH
    for name, m in (("f32", model), ("bf16", model_b)):
        seen, rates = {}, {}
        for pipe in (False, True):
            ev = Evaluator(m, model_points, template_bank=bank)
            ev.evaluate(run[:1])  # warm-up: the first calls' lazy set-up may sync
            fetched, order, syncs = [], [], []
            fetch, dispatch = ev._fetch, ev._dispatch

            def counted_fetch(pending, fetch=fetch, fetched=fetched):
                fetched.append(fetch(pending))
                return fetched[-1]

            def guarded_dispatch(batch, dispatch=dispatch, fetch=fetch, fetched=fetched,
                                 order=order, syncs=syncs, strict=not pipe):
                order.append(len(fetched))
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        pending = dispatch(batch)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                syncs.append(sum("synchronizing CUDA operation" in str(w.message)
                                 for w in caught))
                if strict:  # the reference: batch i done before batch i + 1 is queued
                    fetch(pending)
                return pending

            ev._fetch, ev._dispatch = counted_fetch, guarded_dispatch
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                res = ev.evaluate(run)
            copies = sum(1 for e in prof.events() if e.name.startswith("Memcpy DtoH"))
            want = [0] + list(range(PIPELINE_BATCHES - 1))
            check(order == want and len(fetched) == PIPELINE_BATCHES,
                  f"{name} pipelined={pipe}: batches fetched before each dispatch {order}, "
                  f"expected {want}; {len(fetched)} fetched")
            check(syncs == [1] * PIPELINE_BATCHES,
                  f"{name} pipelined={pipe}: host syncs a dispatch {syncs}, expected the "
                  f"rulebook's one")
            check(copies == 2 * PIPELINE_BATCHES,
                  f"{name} pipelined={pipe}: {copies} device-to-host copies for "
                  f"{PIPELINE_BATCHES} batches")
            ev._fetch = fetch
            if pipe:
                ev._dispatch = dispatch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev.evaluate(run)
            rates[pipe] = rows / (time.perf_counter() - t0)
            seen[pipe] = (np.concatenate([f["adds"] for f in fetched]), res)
        (d0, r0), (d1, r1) = seen[False], seen[True]
        check(np.array_equal(d0, d1), f"{name}: pipelined distances differ from strict order")
        check(json.dumps(r0, sort_keys=True, default=str)
              == json.dumps(r1, sort_keys=True, default=str),
              f"{name}: pipelined summary differs from strict order")
        print(f"pipelined Evaluator ({name}) on {card}: {PIPELINE_BATCHES} batches of {BATCH}, "
              f"per-row distances torch.equal to strict order, two device-to-host copies a "
              f"batch, one sync in a dispatch (the rulebook's read); instances/s strict "
              f"{rates[False]:.1f}, "
              f"pipelined {rates[True]:.1f} (no claim: one run each); the sync-free "
              f"projection {e_proj:.3g} from the SVD's in f64", flush=True)


def profiled_solver_check(card, cfg) -> None:
    """Phase 17(e): a Solver epoch of PROFILE_STEPS steps at batch
    PROFILE_BATCH with cfg.profile_dir: the trace of steps 2-4 holds CUDA
    kernels of K1-K5 (PROFILE_KERNELS)."""
    import tempfile

    import torch

    from dcl_net_tpu_torch.data.loader import BatchLoader
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
    from dcl_net_tpu_torch.train.solver import Solver

    mcfg = cfg.model
    ds = SyntheticPoseDataset(
        n_objects=N_CLASSES, n_points=int(mcfg.n_inp),
        unit_voxel_extent=tuple(mcfg.unit_voxel_extent),
        voxel_num_limit=tuple(int(d) for d in mcfg.voxel_num_limit),
        length=PROFILE_BATCH * PROFILE_STEPS, seed=0)
    loader = BatchLoader(ds, batch_size=PROFILE_BATCH, num_workers=2, seed=1)
    with tempfile.TemporaryDirectory(prefix="dclx_profile_") as tmp:
        solver = Solver(DCLNet.from_config(mcfg, seed=0), dcl_losses,
                        cfg.merge({"per_write": 1, "per_save": 0, "profile_dir": tmp}),
                        loader)
        torch.backends.cudnn.benchmark = False  # Solver turned it on; the phase runs without
        t0 = time.perf_counter()
        solver.train_epoch()
        seconds = time.perf_counter() - t0
        loader.close()
        path = Path(solver.profile_trace_path())
        check(path.is_file(), f"no trace at {path}")
        events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    missing = [k for k, sub in PROFILE_KERNELS if not any(sub in nm for nm in kernels)]
    check(not missing, f"the trace lacks {missing}; its kernels: {sorted(kernels)[:40]}")
    check(solver.state.step == PROFILE_STEPS, f"{solver.state.step} steps")
    print(f"profiled Solver on {card}: {PROFILE_STEPS} steps at batch {PROFILE_BATCH} in "
          f"{seconds:.1f} s; the trace of steps 2-4 ({path.name}, {len(events)} events, "
          f"{len(kernels)} kernel names) holds K1-K5 ({', '.join(s for _, s in PROFILE_KERNELS)})",
          flush=True)


def departures_phase(card, cfg, model, model_b, batches, bank, model_points,
                     entries) -> None:
    """Phase 17 (the module docstring), cuDNN autotuning off."""
    import torch

    t_phase = time.perf_counter()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    grid_shape = tuple(int(d) for d in cfg.model.voxel_num_limit)
    times = {}
    try:
        for part, fn in (
                ("a", lambda: large_voxelize_check(card, grid_shape, entries)),
                ("b", lambda: large_bwd_check(card, entries)),
                ("c", lambda: large_model_check(card, cfg, entries)),
                ("d", lambda: pipelined_eval_check(card, model, model_b, batches, bank,
                                                   model_points)),
                ("e", lambda: profiled_solver_check(card, cfg))):
            t0 = time.perf_counter()
            fn()
            times[part] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = benchmark
    print("departures phase: " + " ".join(f"({k}) {v:.1f} s" for k, v in times.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s", flush=True)


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
    # the same weights in bf16 (model.compute_dtype: bfloat16)
    model_b = DCLNet.from_config(mcfg, seed=0, dtype=torch.bfloat16)
    # the same weights on the fused point-feature path
    model_f = DCLNet.from_config(mcfg, seed=0, interp_mode="pallas_fused")

    if sys.argv[1:] == ["--phase", "15"]:
        # a development run of phase 15 alone: no kernel line, no result line
        parallel_phase(card, cfg, samples, batches, bank, model_points,
                       {k: {} for k in KERNEL_ORDER})
        stop_child_processes()
        print("phase 15 alone: passed", flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "16"]:
        # a development run of phase 16 alone: no kernel line, no result line
        rest_phase(card, cfg, batches, bank, model_points, {k: {} for k in KERNEL_ORDER})
        stop_child_processes()
        print("phase 16 alone: passed", flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "17"]:
        # a development run of phase 17 alone: no kernel line, no result line
        departures_phase(card, cfg, model, model_b, batches, bank, model_points,
                         {k: {} for k in KERNEL_ORDER})
        stop_child_processes()
        print("phase 17 alone: passed", flush=True)
        return 0

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

    # ---- 3b. the bf16 variants of K1, K2, K3, K6 vs their bf16 plain versions --
    bf16_kernel_phase(entries, card, feats, vidx, model_b, grid_shape)
    # ---- 3c. the bf16 variants of K4, K5, K7 vs their bf16 plain versions ------
    bf16_bwd_kernel_phase(entries, card, feats, vidx, model_b, grid_shape)
    del model_b
    torch.cuda.empty_cache()

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
    f32_rates = {"two-stage": inst_s, "fused": rows / t_eval_f}

    # ---- 5. training path at full width -----------------------------------------
    del ev, ev_plain, out, pout, ev_f, out_f, pout_f, pyramid, grid, pgrid
    torch.cuda.empty_cache()
    train_launches, solver, train_batch, perf_two = train_phase(cfg, card)
    for key, n in train_launches.items():
        entries[key]["launches"] = n

    # ---- 6. one train step: kernel path vs plain path ---------------------------
    train_step_vs_plain(solver, train_batch, TWO_STAGE_TRAIN)
    del solver, train_batch
    torch.cuda.empty_cache()

    # ---- 7. the fused path's training, and one step against the two-stage path -
    f_launches, f_solver, f_batch, perf_fused = train_phase(
        cfg, card, "pallas_fused", FUSED_TRAIN_STEPS, FUSED_TRAIN)
    entries["fused"]["launches"] = f_launches["fused"]
    entries["fused_bwd"]["launches"] = f_launches["fused_bwd"]
    print(f"training on {card}: fused {perf_fused['rate']:.2f} samples/s, two-stage "
          f"{perf_two['rate']:.2f} samples/s", flush=True)
    f32_train = {"pallas": perf_two, "pallas_fused": perf_fused}
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

    # ---- 11. bf16 eval, its drift from f32, stage 2 in bf16 ------------------------
    torch.cuda.empty_cache()
    bf16_eval_phase(card, mcfg, batches, bank, model_points, f32_rates, entries)

    # ---- 12. bf16 training on both paths, stage 2 on a frozen bf16 stage 1 -----
    torch.cuda.empty_cache()
    cfg_b = cfg.apply_overrides(["model.compute_dtype=bfloat16"])
    for mode, per_step in (("pallas", TWO_STAGE_TRAIN_BF16), ("pallas_fused", FUSED_TRAIN_BF16)):
        b_launches, b_solver, b_batch, perf = train_phase(cfg_b, card, mode, BF16_TRAIN_STEPS,
                                                          per_step)
        for key in per_step:
            if key.endswith("_bwd_bf16"):
                entries[key]["launches"] = b_launches[key]
        f = f32_train[mode]
        print(f"bf16 training ({mode}) on {card}: {perf['rate']:.2f} samples/s, T_step "
              f"{perf['t_step']:.4f} s, peak memory {perf['peak_gib']:.2f} GiB; f32 in this "
              f"run {f['rate']:.2f} samples/s, T_step {f['t_step']:.4f} s, peak memory "
              f"{f['peak_gib']:.2f} GiB", flush=True)
        bf16_train_step_vs_plain(b_solver, b_batch, per_step)
        del b_solver, b_batch
        torch.cuda.empty_cache()
    model_bf = DCLNet.from_config(mcfg, seed=0, dtype=torch.bfloat16, interp_mode="pallas_fused")
    stage2_train_phase(card, model_bf, model_points, grid_shape, n_points,
                       steps=BF16_STAGE2_TRAIN_STEPS,
                       per_step=(("voxelize_bf16", 2), ("compact_bf16", 8), ("fused_bf16", 8)))
    del model_bf

    # ---- 13. the throughput training path ---------------------------------------
    torch.cuda.empty_cache()
    throughput_phase(card, entries, mcfg, batch_to_torch(batches[0], dev))
    stop_child_processes()

    # ---- 14. serving: the bundle, the poly, stage-2 and bf16 artifacts ---------
    torch.cuda.empty_cache()
    serving_phase(card, mcfg, model, model_f, batches, bank, model_points, inst_s, entries)

    # ---- 15. data parallelism: NCCL at world 1, two gloo ranks on the card -----
    torch.cuda.empty_cache()
    parallel_phase(card, cfg, samples, batches, bank, model_points, entries)

    # ---- 16. the rest of the JAX package: local, modes 0-2, sharded serving, ops --
    torch.cuda.empty_cache()
    rest_phase(card, cfg, batches, bank, model_points, entries)
    stop_child_processes()

    # ---- 17. the last departures from the JAX package: any N and C, pipelining ----
    torch.cuda.empty_cache()
    departures_phase(card, cfg, model, DCLNet.from_config(mcfg, seed=0, dtype=torch.bfloat16),
                     batches, bank, model_points, entries)
    stop_child_processes()

    # ---- 18. result lines -----------------------------------------------------
    print(json.dumps({"kernels": [entries[k] for k in KERNEL_ORDER]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
