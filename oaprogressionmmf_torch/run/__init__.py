"""Command-line apps of the port, ``python -m oaprogressionmmf_torch.run.<app>``
(ports of ``oaprogressionmmf_tpu/run/``), and what they share: the config
tree under ``conf/``, its loading with the app's log file, and the
runtime checks.

Each app has ``main(argv=None, device=None)`` (overrides in the Hydra
grammar: ``model=xr1mr2c1_cnn_trf``, ``a.b=c``, ``+a.b=c``; needs PyYAML)
and ``run(config, device=None, ...)``, which takes a loaded
:class:`~..config.Config` or a plain nested dict and runs on the GPU
unless ``device="cpu"``. The training and evaluation apps run
data-parallel under ``torchrun`` with ``runtime.distributed.enable=true``
(:func:`start_processes`).
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path

CONF_DIR = Path(__file__).parent / "conf"


def as_tree(config) -> dict:
    """A loaded ``Config`` resolved once to a plain dict (so a
    ``${now:...}`` in it is read once), or a dict as it is."""
    return config.to_dict() if hasattr(config, "to_dict") else config


def start_processes(config: dict, device=None) -> tuple:
    """The app's device and data shard ``(rank, world)``. With
    ``runtime.distributed.enable`` the process joins the process group
    (launched one per device, e.g. by ``torchrun --nproc-per-node N``):
    NCCL on ``cuda:LOCAL_RANK``, gloo with ``device="cpu"``. Without it the
    shard is (0, 1). ``runtime.n_devices`` must be unset or the world size
    (more than 1 in a single process raises)."""
    import torch

    from ..device import resolve_device
    from ..parallel.dcn import initialize_distributed

    runtime = config.get("runtime") or {}
    dev = resolve_device(device)
    shard = initialize_distributed(runtime, device=device)
    check_runtime(config)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev, shard


def check_runtime(config: dict) -> None:
    """``runtime.n_devices`` against the running processes: unset, or the
    process group's size (one process per device)."""
    from ..parallel.mesh import create_group

    create_group((config.get("runtime") or {}).get("n_devices"))


@contextlib.contextmanager
def app_config(argv, log_name: str, conf_name: str = "prog_fus.yaml"):
    """Load ``conf/{conf_name}`` with the overrides ``argv``, resolve it
    once, log it and write the log to ``{path_logs}/{log_name}`` too
    (``{training}`` and ``{testing}`` in ``log_name`` become
    ``training.folds.idx`` and ``testing.folds.idx``); yields the plain
    tree. The log file is detached on exit."""
    from ..config import config_from_dict, load_config
    from ..utils.seeding import set_ultimate_seed

    config = config_from_dict(as_tree(load_config(CONF_DIR / conf_name,
                                                  list(argv))))
    logging.basicConfig(level=logging.INFO)
    Path(config.path_logs).mkdir(exist_ok=True, parents=True)
    fh = logging.FileHandler(Path(config.path_logs, log_name.format(
        training=config.training.folds.idx,
        testing=config.testing.folds.idx)))
    fh.setLevel(logging.DEBUG)
    root = logging.getLogger()
    root.addHandler(fh)
    try:
        set_ultimate_seed()
        logging.getLogger("run").info(config.to_yaml(resolve=True))
        yield config.to_dict()
    finally:
        root.removeHandler(fh)
        fh.close()
