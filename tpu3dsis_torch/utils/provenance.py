"""Provenance of saved parameter files (a copy of
``tpu3dsis/utils/provenance.py``).

A saved ``.npz`` of trained parameters gets a ``<file>.provenance.json``
sidecar: the command that made it, its arguments and a deterministic
fingerprint of its config, so that a later run can tell whether the tool's
config has drifted from the one the parameters were trained under. The
fingerprint strips the keys that name host paths and run modes (any key
containing FILELIST, PATH, DIR or MODE) and equals the JAX package's for
the same mapping.
"""

from __future__ import annotations

import hashlib
import json
import os

# keys whose values are host paths / run modes, not model-relevant config
_VOLATILE = ("FILELIST", "PATH", "DIR", "MODE")


def _norm(v):
    import numpy as np

    if isinstance(v, dict):
        return {
            k: _norm(v[k])
            for k in sorted(v)
            if not any(t in str(k) for t in _VOLATILE)
        }
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if v is None or isinstance(v, str):
        return v
    return str(v)


def config_fingerprint(cfg) -> str:
    """sha256 over the sorted, volatile-key-stripped config mapping."""
    blob = json.dumps(_norm(dict(cfg)), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def sidecar_path(fixture_path: str) -> str:
    return fixture_path + ".provenance.json"


def write_provenance(fixture_path: str, command: str, cfg, args: dict,
                     note: str = "") -> str:
    """Write the sidecar next to the fixture; returns its path."""
    p = sidecar_path(fixture_path)
    payload = {
        "fixture": os.path.basename(fixture_path),
        "command": command,
        "args": _norm(args),
        "config_fingerprint": config_fingerprint(cfg),
        "dtype": "float16 (savez_compressed)",
    }
    if note:
        payload["note"] = note
    with open(p, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return p


def read_provenance(fixture_path: str) -> dict:
    with open(sidecar_path(fixture_path)) as f:
        return json.load(f)
