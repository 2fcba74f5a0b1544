"""superconductor-tpu on PyTorch + CUDA: the port of ``superconductor_tpu``
to an NVIDIA H100.

Module paths mirror the reference package (``ops/geometry.py``,
``ops/binning.py``, ``render/frame.py`` ...). The port imports torch and
never jax; the reference's jax-free host modules (asset loading, the
Scene, camera, culling, LOD, procedural environments) come in through
``_host``. Entry points: ``scenes.headline_scene``,
``render.caps.fit_caps``, ``render.frame.render_frame[_stats]``.
"""

__version__ = "0.1.0"
