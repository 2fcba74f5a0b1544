import os

from .fetch import FetchClient, FileClient
from .gltf import Gltf, parse_gltf

# Root of the demo content (the reference's demo/web/assets layout:
# models/Sponza/glTF, cubemaps/noon.ktx2, lighting/uncompressed): the
# repository's assets/ directory, or SC_ASSETS_DIR. The gallery, the demo
# and the frame server look there and fall back to tests/fixtures and
# procedural content where the files are absent.
ASSETS_DIR = os.environ.get(
    "SC_ASSETS_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 "assets"),
)

__all__ = ["ASSETS_DIR", "FetchClient", "FileClient", "Gltf", "parse_gltf"]
