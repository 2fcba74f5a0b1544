from .fetch import FetchClient, FileClient
from .gltf import Gltf, parse_gltf

__all__ = ["FetchClient", "FileClient", "Gltf", "parse_gltf"]
