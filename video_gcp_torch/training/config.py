"""Python-as-config loading for the port (training/config.py of the JAX
package).

Experiment directories hold a `conf.py` exposing `configuration` and
`model_config`, inheriting by importing base configs. Those files import
`video_gcp_tpu.*` and `experiments.*` by name and stay unchanged. They are
executed here with an import hook scoped to their own globals: `video_gcp_tpu.X`
resolves to `video_gcp_torch.X`, and `experiments.*` config modules are
executed from the checkout through the same hook, as is a config that a
conf loads by path with `importlib.util` (9room/gcp_adaptive_dlm). Nothing
is written to `sys.modules`, so the JAX package can be imported in the same
process.
Environment: GCP_DATA_DIR and GCP_EXP_DIR (README.md:37-40), under the
temporary directory when unset.
"""
from __future__ import annotations

import builtins
import importlib
import importlib.machinery
import importlib.util
import os
import tempfile
import types
from datetime import datetime
from pathlib import Path

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.params import ParamDict
from video_gcp_torch.models.hyperparameters import default_hparams

_JAX_PKG, _PORT_PKG = "video_gcp_tpu", "video_gcp_torch"


class _ConfigImporter:
    """Executes config files with a namespace-scoped `__import__`."""

    def __init__(self, experiments_root: Path):
        self.root = experiments_root  # directory that holds experiments/
        self.cache = {}
        self.builtins = dict(builtins.__dict__, __import__=self.import_)

    def exec_file(self, path: Path, name: str) -> types.ModuleType:
        path = path.resolve()
        if path not in self.cache:
            mod = types.ModuleType(name)
            mod.__file__ = str(path)
            mod.__dict__["__builtins__"] = self.builtins
            exec(compile(path.read_text(), str(path), "exec"), mod.__dict__)
            self.cache[path] = mod
        return self.cache[path]

    def import_(self, name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name.split(".")[0] == _JAX_PKG:
            name = _PORT_PKG + name[len(_JAX_PKG):]
        elif level == 0 and name.split(".")[0] == "experiments":
            return self._import_experiments(name, fromlist)
        elif level == 0 and name in ("importlib", "importlib.util"):
            return self._importlib()
        return builtins.__import__(name, globals, locals, fromlist, level)

    def _importlib(self) -> types.ModuleType:
        """`importlib` whose `util.spec_from_file_location` returns a spec
        that executes the file through this importer; every other name is
        the real one."""
        importer = self

        class Loader:
            def __init__(self, path):
                self.path = Path(path).resolve()

            def create_module(self, spec):
                return None

            def exec_module(self, module):
                module.__dict__["__builtins__"] = importer.builtins
                exec(compile(self.path.read_text(), str(self.path), "exec"),
                     module.__dict__)

        def spec_from_file_location(name, location, *args, **kwargs):
            spec = importlib.machinery.ModuleSpec(name, Loader(location),
                                                  origin=str(location))
            spec.has_location = True
            return spec

        util = types.ModuleType("importlib.util")
        util.__getattr__ = lambda attr: getattr(importlib.util, attr)
        util.spec_from_file_location = spec_from_file_location
        shim = types.ModuleType("importlib")
        shim.__getattr__ = lambda attr: getattr(importlib, attr)
        shim.util = util
        return shim

    def _import_experiments(self, name: str, fromlist):
        if not fromlist:
            raise ImportError(f"config import of {name!r}: use "
                              "'from experiments... import ...'")
        path = self.root.joinpath(*name.split("."))
        if path.with_suffix(".py").is_file():
            return self.exec_file(path.with_suffix(".py"), name)
        if not path.is_dir():
            raise ImportError(f"no config module {name!r} under {self.root}")
        pkg = types.ModuleType(name)
        for attr in fromlist:
            setattr(pkg, attr, self.exec_file(path / f"{attr}.py", f"{name}.{attr}"))
        return pkg


def _experiments_root(conf_dir: Path) -> Path:
    for parent in conf_dir.parents:
        if parent.name == "experiments":
            return parent.parent
    raise ValueError(f"{conf_dir} is not inside an experiments/ directory")


def trainer_default_hparams() -> ParamDict:
    """gcp_builder._default_hparams (gcp_builder.py:252-272)."""
    return ParamDict(
        model=None,
        logger=None,
        dataset_name=None,
        batch_size=64,
        exp_path=None,
        num_epochs=200,
        epoch_cycles_train=1,
        optimizer="radam",
        lr=None,
        gradient_clip=None,
        momentum=0,
        adam_beta=0.9,
        metric_pruning_scheme="dtw",
        top_of_100_eval=True,
        n_rooms=None,
    )


def get_data_dir() -> str:
    return os.environ.get("GCP_DATA_DIR",
                          os.path.join(tempfile.gettempdir(), "gcp_data"))


def get_exp_dir() -> str:
    return os.environ.get("GCP_EXP_DIR",
                          os.path.join(tempfile.gettempdir(), "gcp_experiments"))


def get_dataset_path(dataset_name: str) -> str:
    return os.path.join(get_data_dir(), dataset_name)


def datetime_str() -> str:
    return datetime.now().strftime("_%Y-%m-%d_%H-%M-%S")


def dataset_config(dataset_name: str) -> AttrDict:
    """The port's bundled config of a dataset (data/configs/<name>.py: the
    dataset class, its split and render parameters), empty for a dataset
    without one."""
    module = f"{_PORT_PKG}.data.configs.{dataset_name}"
    try:
        return importlib.import_module(module).config
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        return AttrDict(dataset_spec=AttrDict())


def _merge(data_conf: AttrDict, src) -> None:
    for key, val in src.items():
        if key == "dataset_spec":
            data_conf.dataset_spec.update(val)
        else:
            data_conf[key] = val


def load_dataset_spec(data_dir) -> AttrDict:
    """`dataset_spec.py` beside the data (gcp_builder.py:149-163), executed
    through the config import hook: a spec that the JAX package's saver
    wrote imports video_gcp_tpu's AttrDict."""
    path = Path(data_dir) / "dataset_spec.py"
    return AttrDict(_ConfigImporter(path.parent).exec_file(path, "dataset_spec").dataset_spec)


def build_data_conf(dataset_name: str, override=None) -> AttrDict:
    """The dataset directory's dataset_spec.py, when there is one, merged
    with `override` (gcp_builder.py:158-170), which defaults to the port's
    bundled config of the dataset."""
    data_conf = AttrDict(dataset_spec=AttrDict())
    if (Path(get_dataset_path(dataset_name)) / "dataset_spec.py").is_file():
        data_conf.dataset_spec = load_dataset_spec(get_dataset_path(dataset_name))
    _merge(data_conf, dataset_config(dataset_name) if override is None else override)
    return data_conf


def load_config(conf_dir) -> AttrDict:
    """Load `<conf_dir>/conf.py` plus the dataset config into one bundle
    (training/config.py:load_config of the JAX package).

    :return: AttrDict(configuration, model_config, data_conf, conf_path,
        exp_name); `configuration` holds the trainer defaults overwritten by
        the conf, `exp_name` is the conf path below experiments/.
    """
    conf_dir = Path(conf_dir).resolve()
    conf_file = conf_dir / "conf.py"
    if not conf_file.is_file():
        raise ValueError(f"Config file not found: {conf_file}")
    root = _experiments_root(conf_dir)
    conf = _ConfigImporter(root).exec_file(conf_file, "conf")

    configuration = trainer_default_hparams().overwrite(conf.configuration)
    model_config = AttrDict(conf.model_config)
    override = getattr(conf, "data_config", None)
    if configuration.get("dataset_name") is not None:
        data_conf = build_data_conf(configuration["dataset_name"], override)
    else:
        data_conf = AttrDict(dataset_spec=AttrDict())
        _merge(data_conf, override or {})
    data_conf.setdefault("fps", 4)
    # merge dataset dims into the model config (gcp_builder.py:68)
    for key in ("max_seq_len", "n_actions", "state_dim"):
        if key in data_conf.dataset_spec:
            model_config.setdefault(key, data_conf.dataset_spec[key])
    if "dataset_class" in data_conf.dataset_spec:
        model_config.setdefault("dataset_class",
                                data_conf.dataset_spec["dataset_class"])
    return AttrDict(configuration=configuration, model_config=model_config,
                    data_conf=data_conf, conf_path=str(conf_dir),
                    exp_name=str(conf_dir.relative_to(root / "experiments")))


def require_dataset(dataset_name: str) -> None:
    """Check that a named dataset's directory exists (the reference's
    download_data, utils.py:79-93, without its download: the port runs
    where there is no network). The data is made by the port's PRM expert
    from the dataset's data_gen config."""
    path = get_dataset_path(dataset_name)
    if os.path.exists(path):
        return
    raise FileNotFoundError(
        f"dataset {dataset_name!r} not found at {path}. Generate it into $GCP_DATA_DIR "
        f"with the port's PRM expert: python -m video_gcp_torch.planning.run "
        f"experiments/data_gen/{dataset_name}/mod_hyper.py (from a copy of the config, "
        f"with --start_idx/--end_idx for the number of files), or unpack the published "
        f"{dataset_name}.zip there")


def build_hparams(bundle: AttrDict) -> ParamDict:
    """Model hparams = defaults <- model_config, with the strict override rule
    for known keys (the JAX trainer's construction, trainer.py:126-139)."""
    hp = default_hparams()
    mc = dict(bundle.model_config)
    mc.setdefault("batch_size", bundle.configuration.get("batch_size", 64))
    mc.pop("dataset_class", None)
    hp.override({k: v for k, v in mc.items() if k in hp})
    hp.overwrite({k: v for k, v in mc.items() if k not in hp})
    return hp
