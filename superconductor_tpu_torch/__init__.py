"""superconductor-tpu on PyTorch + CUDA: the port of ``superconductor_tpu``
to an NVIDIA H100.

Module paths mirror the reference package (``ops/geometry.py``,
``ops/binning.py``, ``render/frame.py`` ...). The port imports torch and
never jax, and nothing of the reference package: the host side it needs
(asset loading in ``assets/``, the Scene tables in ``scene/``, camera,
culling and LOD in ``render/``, procedural content in ``utils/``, the
native codecs in ``native/``, ``math3d``, ``nodes``, ``animation``) is its
own copy of the reference's jax-free modules. Entry points:
``scenes.headline_scene``, ``render.caps.fit_caps``,
``render.frame.render_frame[_stats]``; they run on the card unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
