"""tuturenderer_tpu: a differentiable path tracer in JAX.

A from-scratch JAX re-design with the capabilities of the reference C++
CPU renderer (bobhansky/TutuRenderer); see SURVEY.md.
"""
import os as _os

import jax as _jax

# the package's checkout: the compile cache lives at <checkout>/.jax_cache
CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself),
    otherwise the fixed ``<checkout>/.jax_cache``: a fixed path keeps the
    cache's keys stable from one process to the next."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
        _os.path.join(CHECKOUT, ".jax_cache")


def _setup_compilation_cache() -> None:
    """Persist compiled executables across processes."""
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir",
                           compilation_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_setup_compilation_cache()

from .camera import Camera, make_camera
from .options import RenderOptions
from .scene.data import SceneBuilder, SceneData

__all__ = ["Camera", "make_camera", "RenderOptions", "SceneBuilder",
           "SceneData"]
__version__ = "0.1.0"
