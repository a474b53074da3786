"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

An AST scan of every module of dcl_net_tpu_torch (the stage-2 refiner,
evaluator, train step and CLI, the fused kernel's wrapper, the YCB-V and
LineMOD readers, the PNG decoder's wrapper, the reference .pth converter
and the YCB-V, LineMOD and Occlusion-LineMOD eval CLIs and the data-parallel package parallel/ and the
multi-process dryrun among them; and of
chip_smoke.py, the scripts/profile_torch_*.py, the tree writers
scripts/ycbv_tree.py and scripts/lm_tree.py and the row counter
scripts/lm_level_occupancy.py and the pooling check
scripts/window_sum_large_batch.py, the multi-GPU scripts
scripts/serve_sharded_multi_gpu.py and scripts/train_ddp_multi_gpu.py and
the convergence acceptance scripts/torch_synthetic_convergence.py), then a fresh interpreter that imports them all with
jax, flax and dcl_net_tpu blocked in sys.modules. Importing builds nothing:
the kernels and the PNG host library are compiled at first use only, so
the import runs with subprocess creation blocked.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "dcl_net_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dcl_net_tpu"}
FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "profile_torch_stage1.py",
                                         ROOT / "scripts" / "profile_torch_train.py",
                                         ROOT / "scripts" / "ycbv_tree.py",
                                         ROOT / "scripts" / "lm_tree.py",
                                         ROOT / "scripts" / "lm_level_occupancy.py",
                                         ROOT / "scripts" / "window_sum_large_batch.py",
                                         ROOT / "scripts" / "serve_sharded_multi_gpu.py",
                                         ROOT / "scripts" / "train_ddp_multi_gpu.py",
                                         ROOT / "scripts" / "torch_synthetic_convergence.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_source(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py"))
    code = "\n".join([
        "import sys",
        f"for name in {sorted(FORBIDDEN)!r}:",
        "    sys.modules[name] = None  # any import of these raises",
        "import subprocess",
        "def no_build(*a, **k):",
        "    raise AssertionError(f'a subprocess was started while importing: {a}')",
        "subprocess.Popen = no_build  # nvcc and g++ run only at first use",
        "import importlib",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "sys.path.insert(0, 'scripts')",
        "import ycbv_tree",
        "import lm_tree",
        "import serve_sharded_multi_gpu",
        "import train_ddp_multi_gpu",
        "import torch_synthetic_convergence",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 30
    for name in ("dcl_net_tpu_torch.data.linemod", "dcl_net_tpu_torch.tools.test_lm",
                 "dcl_net_tpu_torch.tools.test_lmo", "dcl_net_tpu_torch.parallel",
                 "dcl_net_tpu_torch.parallel.mesh",
                 "dcl_net_tpu_torch.tools.dryrun_multihost"):
        assert name in modules


def test_every_kernel_source_names_what_it_replaces():
    for name in ("voxelize.cu", "compact.cu", "interp.cu", "fused.cu"):
        text = (PACKAGE / "csrc" / name).read_text()
        assert "Replaces the Pallas kernel dcl_net_tpu/ops/pallas_" in text
        assert "Bound on an H100" in text
