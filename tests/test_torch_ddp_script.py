"""scripts/train_ddp_multi_gpu.py's rank body over gloo on the CPU.

The script's own functions at a 16^3 grid and 64 points: one process at a
global batch of 4, then two spawned gloo ranks (2 rows each) running the
same cases (3 steps on both point-feature paths in f32 and bf16, a refiner
step, the Evaluator over the group), held by the script's compare() with
chip_smoke.py's bounds (bf16 step-1 losses: the script's BF16_LOSS_RTOL;
on the CPU they differ by about 1e-3, oneDNN's bf16 GEMMs of the heads
rounding otherwise at 2 rows than at 4); and the torchrun launch of the stage-1 CLI at
world 2 on the smoke config, each rank logging one parameter digest.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import train_ddp_multi_gpu as ddp  # noqa: E402
from dcl_net_tpu_torch.config import Config  # noqa: E402
from tests.test_torch_train_cli import SMALL_OVERRIDES  # noqa: E402

torch.set_num_threads(2)

MODEL_OVERRIDES = [o for o in SMALL_OVERRIDES if o.startswith("model.")]


def test_gloo_ranks_hold_to_one_process(tmp_path):
    cfg = Config.fromfile(str(ROOT / "configs" / "config_YCBV_bs32.yaml")).apply_overrides(
        MODEL_OVERRIDES)
    inputs = ddp.make_inputs(cfg, batch=4)
    torch.save(inputs, tmp_path / "inputs.pt")
    ref = ddp.run_all(inputs, None, torch.device("cpu"))
    assert set(ref["train"]) == {f"{m}/{d}" for d in ddp.DTYPES for m in ddp.PATHS}
    ranks = ddp.run_world(2, str(tmp_path), "cpu")
    ok, lines = ddp.compare(ref, ranks, 2, launches=False)
    assert ok, "\n".join(lines)
    assert all(r["backend"] == "gloo" and r["allreduce_ms"] > 0 for r in ranks)
    # a wrong reference is caught: the check is not vacuous
    bad = dict(ref, eval=dict(ref["eval"], summary=dict(ref["eval"]["summary"], n_scored=-1)))
    assert not ddp.compare(bad, ranks, 2, launches=False)[0]


def test_torchrun_launch_of_the_stage1_cli(tmp_path):
    ok, line = ddp.torchrun_check(2, str(tmp_path), overrides=SMALL_OVERRIDES, device="cpu")
    assert ok, line
    assert "2 ranks logged 1 parameter digest(s)" in line


@pytest.mark.parametrize("text, ok", [
    ("rank 0 of 2: parameters sha256 " + "a" * 64 + "\nrank 1 of 2: parameters sha256 "
     + "a" * 64, True),
    ("rank 0 of 2: parameters sha256 " + "a" * 64 + "\nrank 1 of 2: parameters sha256 "
     + "b" * 64, False),
], ids=["same", "differ"])
def test_digest_lines_parse(text, ok):
    digests = {int(r): d for r, w, d in ddp.DIGEST.findall(text)}
    assert sorted(digests) == [0, 1] and (len(set(digests.values())) == 1) == ok
