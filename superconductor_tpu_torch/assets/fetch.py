"""Byte-fetching abstraction for the asset pipeline.

Plays the role of the reference's ``HttpClient`` trait
(the reference engine's renderer-core/src/assets/assets.rs:14-16): everything the
loader touches goes through ``fetch_bytes`` / ``fetch_bytes_range`` so models
can come from disk, an HTTP server, or an in-memory dict (tests). Range
fetches exist because KTX2 streaming pulls individual mip levels
(textures.rs:616-926 in the reference does HTTP range requests per mip).
"""

from __future__ import annotations

import io
import os
import threading
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor, Future
from typing import Dict, Optional


class FetchClient:
    """Base client: synchronous byte fetching plus a shared thread pool.

    The async model/texture pipeline (ecs/systems) submits loads to
    ``executor`` and hands results back to the frame loop, mirroring the
    reference's ``spawn`` + ArcSwap handoff (renderer-core/src/lib.rs:248-267).
    """

    _executor: Optional[ThreadPoolExecutor] = None
    _lock = threading.Lock()

    @classmethod
    def executor(cls) -> ThreadPoolExecutor:
        with cls._lock:
            if cls._executor is None:
                cls._executor = ThreadPoolExecutor(
                    max_workers=int(os.environ.get("SC_TPU_LOADER_THREADS", "8")),
                    thread_name_prefix="sc-asset",
                )
            return cls._executor

    def fetch_bytes(self, url: str) -> bytes:
        raise NotImplementedError

    def fetch_bytes_range(self, url: str, start: int, end: int) -> bytes:
        """Fetch [start, end) — default: whole fetch then slice."""
        return self.fetch_bytes(url)[start:end]

    def submit(self, fn, *args) -> Future:
        return self.executor().submit(fn, *args)

    def resolve(self, base_url: str, relative: str) -> str:
        return urllib.parse.urljoin(base_url, relative)


class FileClient(FetchClient):
    """Local filesystem client; urls are plain paths or file:// urls."""

    def __init__(self, root: Optional[str] = None):
        self.root = root

    def _path(self, url: str) -> str:
        if url.startswith("file://"):
            url = urllib.parse.urlparse(url).path
        if self.root is not None and not os.path.isabs(url):
            return os.path.join(self.root, url)
        return url

    def fetch_bytes(self, url: str) -> bytes:
        with open(self._path(url), "rb") as f:
            return f.read()

    def fetch_bytes_range(self, url: str, start: int, end: int) -> bytes:
        with open(self._path(url), "rb") as f:
            f.seek(start)
            return f.read(end - start)

    def resolve(self, base_url: str, relative: str) -> str:
        if relative.startswith(("http://", "https://", "file://", "data:")):
            return relative
        return os.path.join(os.path.dirname(self._path(base_url)), relative)


class HttpClient(FetchClient):
    """urllib-based HTTP client with real range requests."""

    def fetch_bytes(self, url: str) -> bytes:
        with urllib.request.urlopen(url) as r:
            return r.read()

    def fetch_bytes_range(self, url: str, start: int, end: int) -> bytes:
        req = urllib.request.Request(url, headers={"Range": f"bytes={start}-{end - 1}"})
        with urllib.request.urlopen(req) as r:
            return r.read()


class MemoryClient(FetchClient):
    """In-memory dict client for tests."""

    def __init__(self, files: Dict[str, bytes]):
        self.files = files

    def fetch_bytes(self, url: str) -> bytes:
        return self.files[url]


def decode_data_uri(uri: str) -> bytes:
    import base64

    header, payload = uri.split(",", 1)
    if header.endswith(";base64"):
        return base64.b64decode(payload)
    return urllib.parse.unquote_to_bytes(payload)
