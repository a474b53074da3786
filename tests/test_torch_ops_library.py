"""The forward kernels as torch.library custom ops (ops/library.py).

Each dclx op (K1 voxelize, K2 dense_to_sparse, K3 nn_interpolate, K6
compact_interpolate) passes torch.library.opcheck (schema, fake
implementation against the real one, autograd registration, dispatch) in
f32 and bf16; its CPU result is torch.equal to the plain version it wraps;
and the wrapper that calls it exports with a symbolic batch as one dclx
node, the exported program equal to the eager call at other batch sizes.
Small shapes: an 8^3 grid, 40 points, 30 query points.
"""

import numpy as np
import pytest
import torch

from dcl_net_tpu_torch.ops import cuda_compact, cuda_fused, cuda_interp, cuda_voxelize, library

torch.set_num_threads(2)

GRID = (8, 8, 8)
CAP = 50
UNIT_S, OFF_C = (1.0, 1.0, 1.0), (0.5, 0.5, 0.5)
BF16 = torch.bfloat16


def _grid(rng, b=2):
    feats = torch.from_numpy(rng.randn(b, 40, 7).astype(np.float32))
    vidx = torch.from_numpy(rng.randint(0, 8, (b, 40, 3)).astype(np.int32))
    grid, count = cuda_voxelize.voxelize_reference(feats, vidx, GRID, 4)
    return feats, vidx, grid, (count > 0).to(torch.float32)


def _inputs(op: str, dtype, b=2, seed=0):
    """(args of the op, args of the plain version) at batch b; bf16 rows
    where the op takes rows, a bf16 grid out of K1."""
    rng = np.random.RandomState(seed)
    feats, vidx, grid, mask = _grid(rng, b)
    if op == "voxelize":
        pmask = torch.from_numpy((rng.rand(b, 40) > 0.3).astype(np.float32))
        return (feats, vidx, list(GRID), 3, pmask, dtype), (feats, vidx, GRID, 3, pmask, dtype)
    grid = grid.to(dtype)
    if op == "dense_to_sparse":
        return (grid, mask, CAP), (grid, mask, CAP)
    coords, rows, vmask, occ = cuda_compact.dense_to_sparse_reference(grid, mask, CAP)
    points = torch.from_numpy(rng.rand(b, 30, 3).astype(np.float32)) * 8
    if op == "nn_interpolate":
        args = (points, coords.to(torch.float32) + 0.5, rows, vmask, occ)
        return args, args
    args = (points, coords, rows, vmask, occ, list(UNIT_S), list(OFF_C))
    return args, args


PLAIN = {
    "voxelize": cuda_voxelize.voxelize_reference,
    "dense_to_sparse": cuda_compact.dense_to_sparse_reference,
    "nn_interpolate": cuda_interp.nn_interpolate_reference,
    "compact_interpolate": cuda_fused.compact_interpolate_reference,
}
WRAPPER = {
    "voxelize": lambda feats, vidx, grid, mode, pmask, dtype: cuda_voxelize.voxelize_cuda(
        feats, vidx, tuple(grid), mode, pmask, dtype),
    "dense_to_sparse": cuda_compact.dense_to_sparse_cuda,
    "nn_interpolate": cuda_interp.nn_interpolate_cuda,
    "compact_interpolate": cuda_fused.compact_interpolate_cuda,
}
CASES = [(op, dt) for op in library.OPS for dt in (torch.float32, BF16)]
IDS = [f"{op}-{'bf16' if dt == BF16 else 'f32'}" for op, dt in CASES]


@pytest.mark.parametrize("op, dtype", CASES, ids=IDS)
def test_opcheck(op, dtype):
    args, _ = _inputs(op, dtype)
    torch.library.opcheck(getattr(torch.ops.dclx, op).default, args)


@pytest.mark.parametrize("op, dtype", CASES, ids=IDS)
def test_cpu_result_equals_the_plain_version(op, dtype):
    args, plain_args = _inputs(op, dtype)
    got = getattr(torch.ops.dclx, op)(*args)
    want = PLAIN[op](*plain_args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)
    # the rows' type (K1: out_dtype) is the op's output type
    assert got[1 if op == "dense_to_sparse" else 0].dtype == dtype


def test_voxelize_mode3_outputs_are_dense_and_distinct():
    """In mode 3 the plain version's grid and counts are views of one
    buffer; the op's CPU outputs are dense and do not share storage."""
    args, _ = _inputs("voxelize", None)
    grid, count = torch.ops.dclx.voxelize(*args)
    assert grid.is_contiguous() and count.is_contiguous()
    assert grid.untyped_storage().data_ptr() != count.untyped_storage().data_ptr()


class _Call(torch.nn.Module):
    def __init__(self, op: str, static):
        super().__init__()
        self.op, self.static = op, static

    def forward(self, *tensors):
        args, t = [], iter(tensors)
        for s in self.static:
            args.append(next(t) if s is None else s)
        return WRAPPER[self.op](*args)


@pytest.mark.parametrize("op, dtype", CASES, ids=IDS)
def test_wrapper_exports_with_a_symbolic_batch(op, dtype):
    """The wrapper traces to one dclx node with a symbolic batch (the fake
    implementation's shapes), and the exported program equals the eager
    wrapper at batch sizes other than the traced one."""
    args, _ = _inputs(op, dtype, b=3)
    static = [None if isinstance(a, torch.Tensor) else a for a in args]
    tensors = tuple(a for a in args if isinstance(a, torch.Tensor))
    batch = torch.export.Dim("B", min=1, max=64)
    program = torch.export.export(_Call(op, static), tensors,  # forward(*tensors)
                                  dynamic_shapes=(tuple({0: batch} for _ in tensors),))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert f"dclx.{op}.default" in targets
    # one backed batch symbol, no data-dependent (unbacked) one
    assert len(program.range_constraints) == 1
    assert all(str(s).startswith("s") for s in program.range_constraints)
    module = program.module()
    for b in (1, 5):
        args_b, _ = _inputs(op, dtype, b=b, seed=b)
        tensors_b = tuple(a for a in args_b if isinstance(a, torch.Tensor))
        for g, w in zip(module(*tensors_b), WRAPPER[op](*args_b)):
            assert g.shape[0] == b and torch.equal(g, w)
