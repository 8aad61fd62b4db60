"""Staged checkpoint cache.

Port of sph_tpu/utils/cache.py (reference: sph/utils/Cacheable.hpp:11-63 —
each stage writes a versioned parameter JSON plus LZ4-compressed payloads;
a load checks every parameter against the current settings and refuses a
stale cache; a child stage loads only if its parent stage was itself loaded
from cache, ``cacheDependencyIsValid``).  The files are the JAX package's:
``<file>_<stage>_params.json`` and ``<file>_<stage>_payload.sph4``
(utils/fileio.write_dict), so caches either package writes load in the
other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

from ..settings import settings_to_dict
from . import fileio
from .logging import Log

CACHE_VERSION = "1.0"


def _settings_payload(settings: Any) -> dict:
    if isinstance(settings, tuple):
        return {"__multi__": [settings_to_dict(s) for s in settings]}
    return settings_to_dict(settings)


class StageCache:
    """Per-run stage cache with dependency chaining.  ``loaded(stage)``
    says whether the stage's last load succeeded."""

    def __init__(self, path: str, file_name: str = ""):
        self.path = path
        self.file_name = file_name
        os.makedirs(path, exist_ok=True)
        self._loaded_ok: dict[str, bool] = {}

    def _base(self, stage: str) -> str:
        name = f"{self.file_name}_{stage}" if self.file_name else stage
        return os.path.join(self.path, name)

    def loaded(self, stage: str) -> bool:
        return bool(self._loaded_ok.get(stage))

    def mark(self, stage: str, loaded: bool) -> None:
        """Record a stage's load status kept elsewhere (a shared kNN cache
        mirrored into a run cache)."""
        self._loaded_ok[stage] = loaded

    def load(self, stage: str, settings: Any,
             depends_on: Optional[str] = None) -> Optional[dict]:
        """The stage's payload if its parameters match and its parent stage
        (if any) was loaded from cache, else None."""
        self._loaded_ok[stage] = False
        if depends_on is not None and not self.loaded(depends_on):
            Log.info("StageCache[%s]: dependency '%s' not loaded from "
                     "cache, refusing", stage, depends_on)
            return None
        base = self._base(stage)
        param_file = base + "_params.json"
        data_file = base + "_payload.sph4"
        if not (os.path.exists(param_file) and os.path.exists(data_file)):
            return None
        try:
            with open(param_file) as f:
                stored = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if stored.get("## VERSION ##") != CACHE_VERSION:
            Log.info("StageCache[%s]: version mismatch", stage)
            return None
        if stored.get("settings") != _settings_payload(settings):
            Log.info("StageCache[%s]: settings differ from cache, "
                     "recomputing", stage)
            return None
        try:
            payload = fileio.read_dict(data_file)
        except (OSError, ValueError) as e:
            Log.warn("StageCache[%s]: payload load failed (%s)", stage, e)
            return None
        Log.info("StageCache[%s]: loaded from %s", stage, data_file)
        self._loaded_ok[stage] = True
        return payload

    def write(self, stage: str, settings: Any, payload: dict) -> bool:
        """Write the stage's payload and parameter JSON.  A written stage
        counts as not loaded, so its children's caches, written against
        the old stage, refuse to load (Cacheable.hpp:46)."""
        base = self._base(stage)
        try:
            fileio.write_dict(base + "_payload.sph4", payload)
            with open(base + "_params.json", "w") as f:
                json.dump({"## VERSION ##": CACHE_VERSION,
                           "settings": _settings_payload(settings)}, f,
                          indent=2)
        except OSError as e:
            Log.warn("StageCache[%s]: write failed (%s)", stage, e)
            return False
        self._loaded_ok[stage] = False
        Log.info("StageCache[%s]: wrote %s", stage, base + "_payload.sph4")
        return True
