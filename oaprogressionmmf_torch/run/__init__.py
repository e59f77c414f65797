"""Command-line apps of the port, ``python -m oaprogressionmmf_torch.run.<app>``
(ports of ``oaprogressionmmf_tpu/run/``), and what they share: the config
tree under ``conf/``, its loading with the app's log file, and the
runtime checks.

Each app has ``main(argv=None, device=None)`` (overrides in the Hydra
grammar: ``model=xr1mr2c1_cnn_trf``, ``a.b=c``, ``+a.b=c``; needs PyYAML)
and ``run(config, device=None, ...)``, which takes a loaded
:class:`~..config.Config` or a plain nested dict and runs on the GPU
unless ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path

CONF_DIR = Path(__file__).parent / "conf"

PARALLEL_ITEM = ("data and tensor parallelism are not ported (ROADMAP.md "
                 "§1, the parallelism item)")


def as_tree(config) -> dict:
    """A loaded ``Config`` resolved once to a plain dict (so a
    ``${now:...}`` in it is read once), or a dict as it is."""
    return config.to_dict() if hasattr(config, "to_dict") else config


def initialize_distributed(runtime_cfg) -> tuple[int, int]:
    """The JAX package's multi-process start: the port runs one process,
    whose data shard is (0, 1); ``distributed.enable: true`` raises."""
    dist = (runtime_cfg or {}).get("distributed") or {}
    if dist.get("enable", False):
        raise NotImplementedError(
            f"runtime.distributed.enable=true: {PARALLEL_ITEM}")
    return 0, 1


def check_runtime(config: dict) -> None:
    """Refuse what the port does not run: more than one device, or more
    than one process."""
    runtime = config.get("runtime") or {}
    n_dev = runtime.get("n_devices")
    if n_dev and int(n_dev) > 1:
        raise NotImplementedError(f"runtime.n_devices={n_dev}: "
                                  f"{PARALLEL_ITEM}")
    initialize_distributed(runtime)


@contextlib.contextmanager
def app_config(argv, log_name: str):
    """Load ``conf/prog_fus.yaml`` with the overrides ``argv``, resolve it
    once, log it and write the log to ``{path_logs}/{log_name}`` too
    (``{training}`` and ``{testing}`` in ``log_name`` become
    ``training.folds.idx`` and ``testing.folds.idx``); yields the plain
    tree. The log file is detached on exit."""
    from ..config import config_from_dict, load_config
    from ..utils.seeding import set_ultimate_seed

    config = config_from_dict(as_tree(load_config(CONF_DIR / "prog_fus.yaml",
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
