"""Registry-by-string class resolution (port of
``vae_gslm_tpu/scripts/registry.py``).

Dotted ``identifier`` strings in the YAML configs (the reference's, e.g.
``models.speech.lvtr.LVTR``) locate classes inside this package.  The
JAX registry also tries a bare import; the port resolves inside
``vae_gslm_tpu_torch.`` only, so a config can never pull the JAX
package in.
"""
from __future__ import annotations

import importlib
from typing import Any


def resolve(identifier: str) -> Any:
    module_name, cls_name = identifier.rsplit(".", 1)
    try:
        module = importlib.import_module("vae_gslm_tpu_torch." + module_name)
        return getattr(module, cls_name)
    except (ImportError, AttributeError) as e:
        raise ImportError(f"cannot resolve identifier {identifier!r} inside "
                          "vae_gslm_tpu_torch") from e
