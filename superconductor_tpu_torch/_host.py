"""Host bridge: the reference package's jax-free host modules.

The port reuses the reference's host side (glTF loading, the Scene and its
numpy tables, camera uniforms, culling, LOD selection, procedural
environments, the native codecs) by importing it, never by copying it.
Those modules import jax only inside functions, but importing ANY
submodule of ``superconductor_tpu`` first executes
``superconductor_tpu/__init__.py``, which imports ``render/frame.py`` and
with it jax (superconductor_tpu/__init__.py:15). The reference package
stays as it is, so this module works around its ``__init__``:

* if ``superconductor_tpu`` is already imported, it is used as is;
* else, if jax is already loaded in this process (e.g. beside the
  reference's own tests), the package is imported normally;
* else the package is registered in ``sys.modules`` as a bare package
  whose ``__path__`` is its directory, WITHOUT executing its
  ``__init__.py``; submodules then import normally and jax stays out of
  the process. Whether jax is installed does not matter: the GPU machine
  may have it, and the port must not load it. If code later reads a
  top-level attribute of the bare package (``from superconductor_tpu
  import Scene``), the real ``__init__.py`` runs then, once, so the full
  reference still works in the same process.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types

_PKG = "superconductor_tpu"


def _bare_package(path: list, spec) -> types.ModuleType:
    pkg = types.ModuleType(_PKG)
    pkg.__path__ = path
    pkg.__spec__ = spec
    pkg.__package__ = _PKG
    init_file = os.path.join(path[0], "__init__.py")
    pkg.__file__ = init_file

    def __getattr__(name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        sub = os.path.join(path[0], name)
        if os.path.isdir(sub) or os.path.exists(sub + ".py"):
            # a submodule (`from superconductor_tpu import math3d`): import it
            # without running the package __init__
            return importlib.import_module(f"{_PKG}.{name}")
        if not pkg.__dict__.get("_sc_init_done"):
            pkg.__dict__["_sc_init_done"] = True
            with open(init_file) as f:
                code = compile(f.read(), init_file, "exec")
            exec(code, pkg.__dict__)
        try:
            return pkg.__dict__[name]
        except KeyError:
            raise AttributeError(f"module {_PKG!r} has no attribute {name!r}") from None

    pkg.__getattr__ = __getattr__
    return pkg


def _ensure_reference_package() -> None:
    if _PKG in sys.modules:
        return
    if sys.modules.get("jax") is not None:
        importlib.import_module(_PKG)
        return
    spec = importlib.util.find_spec(_PKG)
    if spec is not None and spec.submodule_search_locations:
        path = list(spec.submodule_search_locations)
    else:
        path = [
            os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                _PKG,
            )
        ]
    sys.modules[_PKG] = _bare_package(path, spec)


_ensure_reference_package()

from superconductor_tpu import math3d  # noqa: E402
from superconductor_tpu import native  # noqa: E402
from superconductor_tpu.assets.models import load_model  # noqa: E402
from superconductor_tpu.render import culling, lod  # noqa: E402
from superconductor_tpu.render.camera import (  # noqa: E402
    Camera,
    Uniforms,
    make_uniforms,
)
from superconductor_tpu.render.env import EnvBindings  # noqa: E402
from superconductor_tpu.scene.scene import (  # noqa: E402
    BLEND_ALPHA_BLENDED,
    BLEND_ALPHA_CLIPPED,
    MAT_DOUBLE_SIDED,
    TEXFLAG_SRGB,
    Model,
    Scene,
    build_mip_chain,
)
from superconductor_tpu.utils.procgen import (  # noqa: E402
    add_pbr_sphere,
    checker_texture,
    default_ambient_sh,
    gradient_cubemap,
)

__all__ = [
    "BLEND_ALPHA_BLENDED",
    "BLEND_ALPHA_CLIPPED",
    "MAT_DOUBLE_SIDED",
    "TEXFLAG_SRGB",
    "add_pbr_sphere",
    "build_mip_chain",
    "checker_texture",
    "Camera",
    "EnvBindings",
    "Model",
    "Scene",
    "Uniforms",
    "culling",
    "default_ambient_sh",
    "gradient_cubemap",
    "load_model",
    "lod",
    "make_uniforms",
    "math3d",
    "native",
]
