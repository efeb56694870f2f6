"""Model registry and repository of the port's serving harness.

Counterpart of ``triton_client_tpu/server/registry.py``: the v2 repository
API's index, load (with a JSON config override or in-request files) and
unload (with ``unload_dependents`` for ensembles), versioned models and
the repository states.  Two sources of models:

* **programmatic**: :meth:`ModelRegistry.register_model`, what the zoo and
  the tests use.  The model's factory hands back the same instance, so an
  unload followed by a load serves that instance again; a plain reload
  restores the registered config where an override changed it.
* **a directory**: Triton's layout ``<repo>/<model>/config.pbtxt`` (the
  protobuf text format, read by ``protocol/text_format.py``) and numbered
  ``<repo>/<model>/<N>/model.py`` files, each exposing
  ``get_model(config)`` that returns a model of this package
  (:class:`~.model.Model`; a model of another package is refused).  Load
  files (``file:<path>`` -> base64) make up an in-request model directory
  in a temporary directory; a path that leaves it is refused.  The config's
  ``version_policy`` picks the versions served: ``latest`` (1 by default),
  ``all`` or ``specific``.

Each load or unload bumps the name's :meth:`ModelRegistry.generation`, as
in the reference; the response cache keys on it (``core._ResponseCache``).
The core tells a swapped instance by identity
(:meth:`ModelRegistry.version_models`).

The rolling-update staging the fleet controller drives (``fleet.py``):
:meth:`ModelRegistry.stage_version` parks a new version outside the
version set, readiness, routing and the index; :meth:`ModelRegistry.promote`
moves it in and makes it the default in one swap under the lock;
:meth:`ModelRegistry.demote` takes a version out again.  None of them moves
the generation: the core tells the promoted instance by identity.
"""

from __future__ import annotations

import base64
import copy
import importlib.util
import os
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..protocol import inference as pb
from ..protocol.text_format import ParseError, parse_json, parse_text
from .model import Model, ModelConfig, config_from_pb
from .types import InferError


class ModelRegistry:
    def __init__(self, repository_path: Optional[str] = None):
        self._factories: Dict[str, Callable[[], Model]] = {}
        self._original_configs: Dict[str, ModelConfig] = {}
        self._models: Dict[str, Model] = {}  # name -> default (latest)
        # name -> {version -> Model}; a programmatic model serves {"1"}
        self._version_sets: Dict[str, Dict[str, Model]] = {}
        self._states: Dict[str, Tuple[str, str]] = {}  # (state, reason)
        self._generations: Dict[str, int] = {}
        # the rolling updates' staging: name -> {version -> Model}, outside
        # the version sets until promoted
        self._staged: Dict[str, Dict[str, Model]] = {}
        self._lock = threading.RLock()
        self._repository_path = repository_path
        if repository_path:
            for entry in sorted(os.listdir(repository_path)):
                if os.path.isdir(os.path.join(repository_path, entry)):
                    self._states.setdefault(entry, ("UNAVAILABLE",
                                                    "unloaded"))

    # -- programmatic registration -----------------------------------------
    def register_model(self, model: Model) -> None:
        with self._lock:
            self._factories[model.name] = lambda m=model: m
            # a load's config override changes this same instance; the
            # snapshot lets a plain reload restore the registered config
            self._original_configs[model.name] = copy.deepcopy(model.config)
            self._models[model.name] = model
            self._version_sets[model.name] = {"1": model}
            self._states[model.name] = ("READY", "")
            self._generations[model.name] = \
                self._generations.get(model.name, 0) + 1

    # -- the v2 repository API ---------------------------------------------
    def load(self, name: str, config_override: Optional[str] = None,
             files: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            try:
                if name in self._factories and not files:
                    model = self._factories[name]()
                    if config_override:
                        model.config = _parse_config_json(config_override,
                                                          name)
                    elif name in self._original_configs:
                        orig = self._original_configs[name]
                        if model.config != orig:
                            model.config = copy.deepcopy(orig)
                    vset = {"1": model}
                elif self._repository_path or files:
                    model, vset = self._load_from_directory(
                        name, config_override, files)
                else:
                    raise InferError(
                        f"failed to load '{name}': model not found")
            except InferError:
                self._states[name] = ("UNAVAILABLE", "load failed")
                raise
            version_list = sorted(vset, key=int)
            for v, m in vset.items():
                m.served_version = v
                m._version_list = version_list
            self._models[name] = model
            self._version_sets[name] = vset
            self._states[name] = ("READY", "")
            self._generations[name] = self._generations.get(name, 0) + 1
            # a load supersedes a rolling update half done: its staged
            # instances are freed
            _unload_quietly(self._staged.pop(name, {}).values())

    def unload(self, name: str, unload_dependents: bool = False) -> None:
        with self._lock:
            model = self._models.pop(name, None)
            if model is None:
                raise InferError(
                    f"failed to unload '{name}': model is not loaded")
            for m in self._version_sets.pop(name, {"_": model}).values():
                m.unload()
            _unload_quietly(self._staged.pop(name, {}).values())
            self._states[name] = ("UNAVAILABLE", "unloaded")
            self._generations[name] = self._generations.get(name, 0) + 1
            if unload_dependents:
                for step in model.config.ensemble_scheduling:
                    if step.model_name in self._models:
                        self.unload(step.model_name)

    def index(self, ready_only: bool = False) -> List[dict]:
        with self._lock:
            out = []
            for name in sorted(self._states):
                state, reason = self._states[name]
                if ready_only and state != "READY":
                    continue
                versions = sorted(self._version_sets.get(name, {"1": None}),
                                  key=int)
                for v in versions:  # one row per served version
                    entry = {"name": name, "version": v, "state": state}
                    if reason:
                        entry["reason"] = reason
                    out.append(entry)
            return out

    def get(self, name: str, version: str = "") -> Model:
        with self._lock:
            model = self._models.get(name)
            vset = self._version_sets.get(name)
        if model is None:
            raise InferError(f"Request for unknown model: '{name}' is not "
                             "found", http_status=400)
        if version:
            m = (vset or {}).get(version)
            if m is None:
                raise InferError(
                    f"Request for unknown model: '{name}' version {version} "
                    "is not found", http_status=400)
            return m
        return model  # unversioned: the policy's latest

    # -- the rolling updates' staging ------------------------------------
    def stage_version(self, name: str, model: Model, version: str) -> None:
        """Park a new version of a loaded name: it takes no traffic and is
        not ready until :meth:`promote`.  The generation does not move."""
        try:
            int(version)
        except (TypeError, ValueError):
            raise InferError(
                f"cannot stage '{name}' version '{version}': versions "
                "are numeric strings")
        with self._lock:
            if name not in self._models:
                raise InferError(
                    f"cannot stage a version for '{name}': model is not "
                    "loaded")
            vset = self._version_sets.get(name) or {}
            staged = self._staged.setdefault(name, {})
            if version in vset or version in staged:
                raise InferError(
                    f"cannot stage '{name}' version {version}: that "
                    "version is already served or staged")
            model.served_version = version
            staged[version] = model

    def staged_version(self, name: str, version: str) -> Optional[Model]:
        with self._lock:
            return self._staged.get(name, {}).get(version)

    def abort_stage(self, name: str, version: str) -> Optional[Model]:
        """Drop a staged instance (a failed warmup, an update abandoned)."""
        with self._lock:
            staged = self._staged.get(name)
            model = staged.pop(version, None) if staged else None
            if staged is not None and not staged:
                self._staged.pop(name, None)
            return model

    def promote(self, name: str, version: str) -> Model:
        """The flip of a rolling update: the staged instance joins the
        served version set and becomes the default (unversioned) target,
        in one swap under the lock.  Requests that resolved the old
        instance keep it; the old version stays served and addressable."""
        with self._lock:
            staged = self._staged.get(name, {})
            model = staged.pop(version, None)
            if model is None:
                raise InferError(
                    f"no staged version {version} for '{name}' to promote")
            if not staged:
                self._staged.pop(name, None)
            vset = self._version_sets.setdefault(name, {})
            vset[version] = model
            version_list = sorted(vset, key=int)
            for m in vset.values():
                m._version_list = version_list
            self._models[name] = model
            self._states[name] = ("READY", "")
            return model

    def demote(self, name: str, version: str,
               fallback: Optional[str] = None) -> Model:
        """Take one served version out (a rollback): the default returns
        to ``fallback`` where it is served, else the highest version left.
        The only version cannot be demoted: that is an unload."""
        with self._lock:
            vset = self._version_sets.get(name) or {}
            if version not in vset:
                raise InferError(
                    f"cannot demote '{name}' version {version}: not served")
            if len(vset) == 1:
                raise InferError(
                    f"cannot demote the only served version of '{name}' "
                    "(unload the model instead)")
            model = vset.pop(version)
            version_list = sorted(vset, key=int)
            for m in vset.values():
                m._version_list = version_list
            if fallback is not None and fallback in vset:
                self._models[name] = vset[fallback]
            elif self._models.get(name) is model:
                self._models[name] = vset[version_list[-1]]
            return model

    def generation(self, name: str) -> int:
        """Bumped whenever the instance behind ``name`` is swapped (load,
        reload, unload)."""
        with self._lock:
            return self._generations.get(name, 0)

    def set_state(self, name: str, state: str, reason: str = "") -> None:
        """A name's repository state (READY / LOADING / UNAVAILABLE)."""
        with self._lock:
            self._states[name] = (state, reason)

    def get_state(self, name: str) -> Tuple[str, str]:
        """(state, reason) of a name; ("", "") where unknown."""
        with self._lock:
            return self._states.get(name, ("", ""))

    def any_loading(self) -> bool:
        """True while any model is LOADING (the server's readiness)."""
        with self._lock:
            return any(s == "LOADING" for s, _ in self._states.values())

    def is_ready(self, name: str, version: str = "") -> bool:
        with self._lock:
            if self._states.get(name, ("", ""))[0] != "READY":
                return False
            model = self._models.get(name)
            vset = self._version_sets.get(name) or {}
        return model is not None and (not version or version in vset)

    def ready_models(self) -> List[Model]:
        """One (default) instance per loaded name."""
        with self._lock:
            return list(self._models.values())

    models = ready_models

    def all_version_models(self) -> List[Model]:
        """Every served version's instance."""
        with self._lock:
            return [m for vs in self._version_sets.values()
                    for m in vs.values()]

    def version_models(self, name: str) -> List[Model]:
        """Every served version of one name, ascending."""
        with self._lock:
            vset = self._version_sets.get(name)
            if vset:
                return [vset[v] for v in sorted(vset, key=int)]
            m = self._models.get(name)
            return [m] if m is not None else []

    # -- directory loading ---------------------------------------------------
    def _load_from_directory(self, name: str, config_override, files):
        model_dir = None
        if files:
            # the in-request model directory: "file:1/model.py" -> base64
            tmp = tempfile.mkdtemp(prefix=f"tc_torch_model_{name}_")
            for fname, b64 in files.items():
                rel = (fname[len("file:"):] if fname.startswith("file:")
                       else fname)
                dest = os.path.normpath(os.path.join(tmp, rel))
                # a request-controlled name must stay inside the directory
                if not dest.startswith(tmp + os.sep):
                    raise InferError(
                        f"failed to load '{name}': invalid file path "
                        f"'{rel}'")
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                with open(dest, "wb") as f:
                    f.write(base64.b64decode(b64))
            model_dir = tmp
        elif self._repository_path:
            model_dir = os.path.join(self._repository_path, name)
        if model_dir is None or not os.path.isdir(model_dir):
            raise InferError(
                f"failed to load '{name}': not found in repository")

        if config_override:
            config = _parse_config_json(config_override, name)
        else:
            cfg_path = os.path.join(model_dir, "config.pbtxt")
            if not os.path.exists(cfg_path):
                raise InferError(
                    f"failed to load '{name}': missing config.pbtxt")
            with open(cfg_path) as f:
                text = f.read()
            try:
                msg = parse_text(text, pb.ModelConfig)
            except ParseError as e:
                raise InferError(
                    f"failed to load '{name}': config.pbtxt: {e}")
            config = config_from_pb(msg, name)

        available = sorted(
            int(d) for d in os.listdir(model_dir)
            if d.isdigit() and os.path.exists(
                os.path.join(model_dir, d, "model.py")))
        if not available:
            raise InferError(f"failed to load '{name}': missing 1/model.py")
        chosen = _apply_version_policy(name, config, available)

        def load_version(v: int) -> Model:
            impl_path = os.path.join(model_dir, str(v), "model.py")
            try:
                spec = importlib.util.spec_from_file_location(
                    f"tc_torch_models.{name}.v{v}", impl_path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except Exception as e:  # noqa: BLE001 - a load error
                raise InferError(
                    f"failed to load '{name}' version {v}: model.py failed "
                    f"to import: {type(e).__name__}: {e}")
            if not hasattr(mod, "get_model"):
                raise InferError(
                    f"failed to load '{name}' version {v}: model.py lacks "
                    "get_model(config)")
            try:
                model = mod.get_model(copy.deepcopy(config))
            except InferError:
                raise
            except Exception as e:  # noqa: BLE001 - a load error
                raise InferError(
                    f"failed to load '{name}' version {v}: get_model "
                    f"raised {type(e).__name__}: {e}")
            if not isinstance(model, Model):
                # a model.py written for the JAX package builds that
                # package's Model, which this server cannot run
                raise InferError(
                    f"failed to load '{name}' version {v}: get_model "
                    f"returned a {type(model).__module__}."
                    f"{type(model).__qualname__}, not a "
                    "triton_client_tpu_torch.server.model.Model")
            model.model_dir = model_dir
            return model

        vset: Dict[str, Model] = {}
        try:
            for v in chosen:
                vset[str(v)] = load_version(v)
        except Exception:
            # a later version failing must not leak what the earlier ones
            # built (device memory included)
            for m in vset.values():
                try:
                    m.unload()
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass
            raise
        return vset[str(max(chosen))], vset


def _unload_quietly(models) -> None:
    for m in models:
        try:
            m.unload()
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass


def _apply_version_policy(name: str, config: ModelConfig,
                          available: List[int]) -> List[int]:
    """The repository's numbered versions that are served (the config's
    ``ModelVersionPolicy``: latest{n}, 1 by default; all; specific)."""
    policy = config.version_policy
    which = policy.WhichOneof("policy_choice") if policy is not None \
        else None
    if which == "all":
        return available
    if which == "specific":
        wanted = sorted(int(v) for v in policy.specific.versions)
        missing = [v for v in wanted if v not in available]
        if missing:
            raise InferError(
                f"failed to load '{name}': version_policy requests "
                f"version(s) {missing} not present in the repository")
        if not wanted:
            raise InferError(
                f"failed to load '{name}': version_policy specific lists "
                "no versions")
        return wanted
    n = (policy.latest.num_versions if which == "latest" else 0) or 1
    return available[-n:]


def _parse_config_json(config_json: str, name: str) -> ModelConfig:
    try:
        msg = parse_json(config_json, pb.ModelConfig)
    except ParseError as e:
        raise InferError(
            f"failed to parse config override for '{name}': {e}")
    return config_from_pb(msg, name)
