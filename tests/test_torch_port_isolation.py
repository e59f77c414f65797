"""The port stands alone: it imports neither JAX nor the JAX package, nor
flax or msgpack (the machine with the card has neither; the port reads and
writes bundles itself), and its entry points refuse to fall back to the
CPU unless asked."""

import hashlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import oaprogressionmmf_torch
from oaprogressionmmf_torch import resolve_device
from oaprogressionmmf_torch.ops import _build
from oaprogressionmmf_torch.serving import make_predictor
from oaprogressionmmf_torch.train.trainer import (ProgressionTrainer,
                                                  TrainRuntime)
from torch_port_util import FLAGSHIP_MODALS, FLAGSHIP_SMALL

REPO = Path(__file__).resolve().parents[1]
# every module of the package, found by walking it, so that a new module
# is held to the rule too
PORT_MODULES = ["oaprogressionmmf_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(oaprogressionmmf_torch.__path__,
                                          "oaprogressionmmf_torch."))


def test_the_module_walk_finds_the_whole_package():
    on_disk = {
        ".".join(path.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for path in (REPO / "oaprogressionmmf_torch").rglob("*.py")}
    assert set(PORT_MODULES) == on_disk
    assert "oaprogressionmmf_torch.train.state" in PORT_MODULES


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'msgpack',\n"
        "          'oaprogressionmmf_tpu'):\n"
        "    sys.modules[m] = None\n"
        "before = set(sys.modules)\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = [m for m in set(sys.modules) - before\n"
        "          if m.startswith(('jax', 'flax', 'msgpack',\n"
        "                           'oaprogressionmmf_tpu'))]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


# the evaluation half and the apps, named so that a rename cannot drop
# them from the walk unnoticed
EVAL_MODULES = ("oaprogressionmmf_torch.config",
                "oaprogressionmmf_torch.train.evaluator",
                "oaprogressionmmf_torch.analysis",
                "oaprogressionmmf_torch.run",
                "oaprogressionmmf_torch.run.train_prog_fus",
                "oaprogressionmmf_torch.run.eval_prog_fus",
                "oaprogressionmmf_torch.run.export_serving",
                "oaprogressionmmf_torch.run.analyze_results")


# the data-preparation layer, named for the same reason
PREP_MODULES = ("oaprogressionmmf_torch.utils.dicom",
                "oaprogressionmmf_torch.utils.native_io",
                "oaprogressionmmf_torch.utils.formats",
                "oaprogressionmmf_torch.utils.sas",
                "oaprogressionmmf_torch.ops.t2_fit",
                "oaprogressionmmf_torch.data.t2_mapping",
                "oaprogressionmmf_torch.prior_art",
                "oaprogressionmmf_torch.prior_art.tiulpin2019",
                "oaprogressionmmf_torch.run.prepare_data_mri_oai",
                "oaprogressionmmf_torch.run.prepare_data_xr_oulu",
                "oaprogressionmmf_torch.run.prepare_targets_oai")


# the parallel layer, the clinical baselines and the backends that stand
# in for grain and orbax, named for the same reason
PARALLEL_MODULES = ("oaprogressionmmf_torch.parallel",
                    "oaprogressionmmf_torch.parallel.dcn",
                    "oaprogressionmmf_torch.parallel.mesh",
                    "oaprogressionmmf_torch.parallel.tp",
                    "oaprogressionmmf_torch.run.train_prog_clin",
                    "oaprogressionmmf_torch.data.pipeline",
                    "oaprogressionmmf_torch.utils.checkpoint",
                    "oaprogressionmmf_torch.utils.pretrained")


def test_port_imports_without_the_host_packages():
    """The machine with the card has no pandas, scikit-learn, PyYAML, PIL,
    cv2 or matplotlib: every module of the port imports without them (the
    data layer and the prep apps import pandas and PIL inside the functions
    that read data; the config loader and the apps PyYAML, the analysis
    pandas, SciPy and matplotlib, the clinical baselines scikit-learn
    inside the functions that need them), and none needs grain or orbax
    (the worker loader and the checkpoint directories are torch's)."""
    assert set(EVAL_MODULES) <= set(PORT_MODULES)
    assert set(PREP_MODULES) <= set(PORT_MODULES)
    assert set(PARALLEL_MODULES) <= set(PORT_MODULES)
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'msgpack',\n"
        "          'oaprogressionmmf_tpu', 'pandas', 'sklearn', 'yaml',\n"
        "          'PIL', 'cv2', 'matplotlib', 'grain', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax_module():
    for path in (REPO / "oaprogressionmmf_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            code = line.split("#")[0]
            assert not code.lstrip().startswith(
                ("import jax", "from jax", "import flax", "from flax",
                 "import msgpack", "from msgpack", "import grain",
                 "from grain", "import orbax", "from orbax",
                 "from oaprogressionmmf_tpu", "import oaprogressionmmf_tpu")
            ), f"{path}: {line}"


def test_bundle_codec_runs_without_msgpack_or_flax(tmp_path):
    """The port's msgpack reader and writer round-trip a bundle payload in
    a process where msgpack and flax cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from oaprogressionmmf_torch.utils import msgpack_io\n"
        "tree = {'params': {'w': np.arange(6, dtype=np.float32)},\n"
        "        'bf': torch.ones(3, dtype=torch.bfloat16),\n"
        "        'quant_acts': {'amax': np.float32(2.0)}}\n"
        f"path = {str(tmp_path / 'b.msgpack')!r}\n"
        "msgpack_io.write_msgpack(path, tree)\n"
        "got = msgpack_io.read_msgpack(path)\n"
        "assert (got['params']['w'] == tree['params']['w']).all()\n"
        "assert torch.equal(got['bf'], tree['bf'])\n"
        "assert got['quant_acts']['amax'] == 2.0\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_predictor(FLAGSHIP_SMALL, {}, FLAGSHIP_MODALS,
                       FLAGSHIP_SMALL["downscale"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainRuntime({"model": FLAGSHIP_SMALL, "training": {}},
                     FLAGSHIP_MODALS, FLAGSHIP_SMALL["downscale"], 1,
                     device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProgressionTrainer({"model": FLAGSHIP_SMALL}, 0, device=None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_evaluation_entry_points_raise_without_a_gpu(monkeypatch):
    """The evaluator and the apps take the card unless the caller asks for
    the CPU; without a GPU they raise before reading any data."""
    from oaprogressionmmf_torch.run import (eval_prog_fus, export_serving,
                                            train_prog_fus)
    from oaprogressionmmf_torch.train.evaluator import ProgressionEvaluator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProgressionEvaluator({"model": FLAGSHIP_SMALL})
    for app in (train_prog_fus, eval_prog_fus, export_serving):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            app.run({"model": FLAGSHIP_SMALL, "runtime": {},
                     "training": {"folds": {"idx": 0}}})


def test_kernel_build_is_keyed_by_its_source(tmp_path, monkeypatch):
    """A library built from one source and one set of nvcc flags is reused
    for them; an edited source or a changed flag is rebuilt, never served
    by the stale library."""
    assert (_build.CSRC_DIR / "flash_fwd.cu").exists()
    assert _build.BUILD_DIR == REPO / "build"
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// v1")
    digest = hashlib.sha1(
        b"// v1" + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = tmp_path / "build" / f"libk-{digest}.so"
    lib.parent.mkdir()
    lib.write_bytes(b"")
    assert _build.build("k") == (lib, "")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    flags = _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags + ("-G",))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    (tmp_path / "k.cu").write_text("// v2")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("k")
