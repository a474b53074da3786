"""The port's registry and package surface against the JAX package's.

dcl_net_tpu_torch/registry.py is a copy of dcl_net_tpu/registry.py; the
models and datasets register under the JAX package's names;
tools/common.py::build_model resolves cfg.model.name through MODELS; each
subpackage's __init__ exports the JAX subpackage's names, less the names of
JAX concepts listed here; importing the package loads no CUDA and builds
no kernel.
"""

import importlib
import subprocess
import sys
import types
from pathlib import Path

import pytest

import dcl_net_tpu
import dcl_net_tpu_torch
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.registry import DATASETS, MODELS, Registry

ROOT = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("", "models", "data", "train", "eval", "geometry", "ops", "parallel")
# names of JAX concepts, which the port does not export: the batch moved to
# JAX arrays (the port's is batch_to_torch), the Pallas 3-NN interpolation
# (kernel K3 here, ops/cuda_interp.py::nn_interpolate), and the jax.sharding
# mesh and its shardings (the port's data parallelism is torch.distributed)
JAX_ONLY = {
    "data": {"batch_to_jax"},
    "ops": {"pallas_nn_interpolate"},
    "parallel": {"make_mesh", "batch_sharding", "replicated_sharding"},
}
DATASET_MODULES = ("data.synthetic", "data.ycbv", "data.linemod")


def _public(module) -> set:
    """The names a package's __init__ exports: its attributes that are not
    modules (a submodule's name is there once it has been imported) and not
    private, nor __version__."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and n not in ("annotations",)}


def test_registry_register_get_and_errors():
    reg = Registry("things")

    @reg.register()
    class Thing:
        pass

    @reg.register("other")
    def make():
        return 1

    assert reg.get("Thing") is Thing and reg.get("other") is make
    assert "Thing" in reg and "missing" not in reg
    assert sorted(reg.keys()) == ["Thing", "other"]
    with pytest.raises(KeyError, match="already registered in things"):
        reg.register("other")(object)
    with pytest.raises(KeyError, match=r"'nope' not found in registry things; "
                       r"available: \['Thing', 'other'\]"):
        reg.get("nope")


def test_registries_hold_the_jax_keys():
    import dcl_net_tpu.models  # noqa: F401
    import dcl_net_tpu_torch.models  # noqa: F401

    for m in DATASET_MODULES:
        importlib.import_module(f"dcl_net_tpu.{m}")
        importlib.import_module(f"dcl_net_tpu_torch.{m}")
    assert set(MODELS.keys()) == set(dcl_net_tpu.MODELS.keys()) == {"DCL_Net", "Refiner"}
    assert set(DATASETS.keys()) == set(dcl_net_tpu.DATASETS.keys()) == {
        "synthetic", "ycbv_train", "ycbv_test", "linemod", "lmo"}
    from dcl_net_tpu_torch.data.linemod import LineMODDataset, OcclusionLineMODDataset
    from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
    from dcl_net_tpu_torch.data.ycbv import YCBVTestDataset, YCBVTrainDataset
    from dcl_net_tpu_torch.models import DCLNet, Refiner

    assert MODELS.get("DCL_Net") is DCLNet and MODELS.get("Refiner") is Refiner
    for key, cls in (("synthetic", SyntheticPoseDataset), ("ycbv_train", YCBVTrainDataset),
                     ("ycbv_test", YCBVTestDataset), ("linemod", LineMODDataset),
                     ("lmo", OcclusionLineMODDataset)):
        assert DATASETS.get(key) is cls


def _small_cfg(**model) -> Config:
    return Config({"model": {"voxelization_mode": 4, "unit_voxel_extent": [0.024] * 3,
                             "voxel_num_limit": [16, 16, 16], "n_inp": 64, "n_tmp": 64,
                             **model}})


def test_build_model_resolves_through_models(monkeypatch):
    from dcl_net_tpu_torch.models import DCLNet
    from dcl_net_tpu_torch.tools.common import build_model

    model = build_model(_small_cfg(), device="cpu")
    assert type(model) is DCLNet
    assert type(build_model(_small_cfg(name="DCL_Net"), device="cpu")) is DCLNet
    with pytest.raises(KeyError, match="'NoSuchNet' not found in registry models"):
        build_model(_small_cfg(name="NoSuchNet"), device="cpu")

    built = []

    class Stub:
        @classmethod
        def from_config(cls, m, device=None, seed=0):
            built.append((dict(m), device, seed))
            return cls()

    monkeypatch.setitem(MODELS._entries, "StubNet", Stub)
    assert type(build_model(_small_cfg(name="StubNet"), device="cpu", seed=3)) is Stub
    assert built[0][0]["name"] == "StubNet" and built[0][1:] == ("cpu", 3)


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_subpackage_exports_the_jax_names(sub):
    jax_pkg = importlib.import_module("dcl_net_tpu" + (f".{sub}" if sub else ""))
    port = importlib.import_module("dcl_net_tpu_torch" + (f".{sub}" if sub else ""))
    jax_only = JAX_ONLY.get(sub, set())
    want = _public(jax_pkg) - jax_only
    assert jax_only <= _public(jax_pkg)  # each listed name is a JAX export
    missing = {n for n in want if not hasattr(port, n)}
    assert not missing, f"dcl_net_tpu_torch{'.' + sub if sub else ''} lacks {sorted(missing)}"
    assert not jax_only & _public(port)
    for n in want:  # the same kind of thing: a class for a class, a callable for one
        j, t = getattr(jax_pkg, n), getattr(port, n)
        if isinstance(j, type):
            assert isinstance(t, type), n
        elif callable(j):
            assert callable(t), n


def test_models_import_form_and_no_kernel_build():
    code = "\n".join([
        "import subprocess, sys",
        "def no_build(*a, **k):",
        "    raise AssertionError(f'a subprocess was started while importing: {a}')",
        "subprocess.Popen = no_build",
        "import dcl_net_tpu_torch",
        "from dcl_net_tpu_torch import Config, Registry, MODELS, DATASETS",
        "from dcl_net_tpu_torch.models import DCLNet, Refiner, dcl_losses",
        "from dcl_net_tpu_torch.data import make_batch, SyntheticPoseDataset",
        "from dcl_net_tpu_torch.train import Solver, make_train_step, autoclip",
        "from dcl_net_tpu_torch.eval import Evaluator, Stage2Evaluator",
        "from dcl_net_tpu_torch.parallel import make_parallel_train_step",
        "import torch",
        "assert not torch.cuda.is_initialized()",
        "from dcl_net_tpu_torch.ops import cuda_build",
        "assert cuda_build.library.cache_info().currsize == 0  # no kernel library loaded",
        "print(sorted(MODELS.keys()))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['DCL_Net', 'Refiner']"
