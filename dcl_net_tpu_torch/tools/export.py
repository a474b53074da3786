"""Export the trained eval forward of the port as a serving artifact.

Usage:
  python -m dcl_net_tpu_torch.tools.export --config configs/config_YCBV_bs32.yaml \
      --checkpoint log/.../epoch_84 --out dclnet_ycbv.pt2 --batch 512

Counterpart of dcl_net_tpu/tools/export.py. Writes one .pt2 file (weights
and the per-class template cache carried in it; see
dcl_net_tpu_torch/serving.py), or with --bundle a directory of fixed-batch
artifacts, a batch-polymorphic one and a manifest, which
serving.BundleServer serves at any request size. --checkpoint (and
--checkpoint_refiner) take a checkpoint directory of the port or a
reference .pth. The artifact is exported on the card, where it will run,
unless --device names another device (--device cpu: a CPU artifact).

--n_devices N (or any data-parallel launch of tools/common.py::run_tool)
exports the data-parallel artifact of N ranks: the per-rank program of
--batch / N rows, which serving.load_serve(path, group=...) serves over a
group of N ranks (the JAX package's mesh-sharded artifact). The ranks
check that they hold the same weights; rank 0 writes the file.
"""

from __future__ import annotations


def _bank_dataset(cfg):
    """The dataset whose CAD template bank goes into the artifact, as the
    eval CLIs choose it: the test dataset's config, template clouds of
    tmp_size points (the bank is [C, n_tmp, 7])."""
    ds_cfg = cfg.get("hyper_dataset_test") or cfg.hyper_dataset_train
    name = ds_cfg.name
    if name == "synthetic":
        from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset

        return SyntheticPoseDataset(
            n_points=int(ds_cfg.get("tmp_size", ds_cfg.input_size)),
            unit_voxel_extent=tuple(ds_cfg.unit_voxel_extent),
            voxel_num_limit=tuple(int(v) for v in ds_cfg.voxel_num_limit),
            length=int(ds_cfg.get("length", 64)),
        )
    if name == "ycbv_test":
        from dcl_net_tpu_torch.data.ycbv import YCBVTestDataset
        from dcl_net_tpu_torch.tools.common import ycbv_dirs

        root, assets = ycbv_dirs(cfg)
        return YCBVTestDataset(ds_cfg, root, assets_dir=assets)
    if name == "linemod":
        from dcl_net_tpu_torch.data.linemod import LineMODDataset
        from dcl_net_tpu_torch.tools.common import lm_root

        return LineMODDataset("test", ds_cfg, lm_root(cfg))
    raise KeyError(f"no template-bank source for dataset {name!r}")


def main(argv=None):
    from dcl_net_tpu_torch.tools.common import base_parser, run_tool

    parser = base_parser("DCL-Net serving export, stage 1 or refined (PyTorch)")
    parser.add_argument("--out", default=None, help="artifact output path (.pt2)")
    parser.add_argument(
        "--bundle", default=None,
        help="output DIRECTORY for an artifact bundle instead of one file: "
        "fixed-batch artifacts (--bundle_batches) + a batch-polymorphic "
        "catch-all, with a manifest; serve any request size via "
        "serving.BundleServer (stage-1 only)")
    parser.add_argument("--bundle_batches", default="1,16,64,512",
                        help="comma-separated fixed batch sizes for --bundle")
    parser.add_argument("--batch", default=None,
                        help="serving batch size (default: eval bs), or 'poly' for a "
                        "batch-polymorphic artifact (one artifact serves any batch "
                        "up to serving.poly_max_batch); with --n_devices N the global "
                        "batch, N dividing it")
    parser.add_argument(
        "--checkpoint_refiner", default=None,
        help="stage-2 refiner checkpoint; exports the full refined pipeline "
        "(stage 1 + iterative refiner in one graph)")
    parser.add_argument("--stage2", action="store_true",
                        help="export the refined pipeline even without a refiner "
                        "checkpoint (smoke mode: seeded weights)")
    parser.add_argument("--iteration", default=2, type=int,
                        help="refine iterations in a stage-2 artifact")
    args = parser.parse_args(argv)
    if (args.out is None) == (args.bundle is None):
        parser.error("exactly one of --out / --bundle is required")
    if args.bundle and (args.stage2 or args.checkpoint_refiner):
        parser.error("--bundle exports the stage-1 pipeline")
    return run_tool(args, argv, main, _export)


def _export(args, group, device):
    """The export on one process, or on each rank of a data-parallel group
    (rank 0 writes the artifact)."""
    from functools import partial

    from dcl_net_tpu_torch.models.refiner import Refiner
    from dcl_net_tpu_torch.parallel.mesh import barrier, replicate
    from dcl_net_tpu_torch.serving import (
        check_world, export_bundle, export_serve, export_serve_stage2, save_bundle,
    )
    from dcl_net_tpu_torch.tools.common import build_model, init, load_model_weights

    world = group.world if group is not None else 1
    logger, cfg = init(args, "export", group)
    model = build_model(cfg, device=device)
    if args.checkpoint:
        load_model_weights(model, args.checkpoint)
    else:
        # export from seeded weights: exercises the artifact pipeline without
        # a checkpoint (smoke, testing); a real deployment passes one
        logger.warning("no --checkpoint: exporting seeded weights (smoke mode)")
    replicate(model, group)
    bank = _bank_dataset(cfg).template_bank()
    n_points = int(cfg.model.n_inp)
    main_rank = group is None or group.is_main

    if args.bundle:
        if world > 1:
            raise ValueError("--bundle: a bundle serves one process; export the sharded "
                             "artifact with --out")
        sizes = [int(b) for b in args.bundle_batches.split(",") if b.strip()]
        artifacts = export_bundle(model, bank, n_points, batch_sizes=sizes)
        mpath = save_bundle(args.bundle, artifacts, model)
        total = sum(len(d) for d in artifacts.values())
        logger.warning(
            f"exported serving bundle: {args.bundle} ({len(artifacts)} artifacts incl. "
            f"poly, {total / 1e6:.1f} MB, batches={sizes}, device={device}); "
            f"manifest: {mpath}")
        return args.bundle

    if args.batch == "poly":
        bs = None
    else:
        bs = int(args.batch) if args.batch else int(
            cfg.get("hyper_dataloader_test", {}).get("bs", 512)
            if cfg.get("hyper_dataloader_test") else 512)

    check_world(bs, world)  # on every rank, before rank 0 exports
    if args.stage2 or args.checkpoint_refiner is not None:
        refiner = Refiner(n_inp=n_points, device=device, seed=int(cfg.get("rd_seed", 1)))
        if args.checkpoint_refiner:
            load_model_weights(refiner, args.checkpoint_refiner)
        else:
            logger.warning("no --checkpoint_refiner: exporting seeded refiner weights "
                           "(smoke mode)")
        replicate(refiner, group)
        export = partial(export_serve_stage2, model, refiner, bank, bs,
                         iterations=int(args.iteration), world=world)
        kind = f"refined (x{args.iteration})"
    else:
        export = partial(export_serve, model, bank, bs, n_points, world=world)
        kind = "stage-1"
    if main_rank:
        data = export()
        with open(args.out, "wb") as f:
            f.write(data)
        logger.warning(
            f"exported {kind} serving artifact: {args.out} ({len(data) / 1e6:.1f} MB, "
            f"batch={'poly' if bs is None else bs}, device={device}"
            f"{f', world={world}' if world > 1 else ''})")
    barrier(group)
    return args.out


if __name__ == "__main__":
    main()
