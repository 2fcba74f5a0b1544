"""Async texture streaming: dummy hot-swap + smallest-mip-first loading.

Reproduces the reference's texture pipeline behavior
(texture_loading.rs:76-336 + textures.rs:616-926):

  * materials draw immediately with 1x1 dummy textures;
  * texture fetch+decode runs on the loader thread pool;
  * KTX2 textures stream progressively: the smallest mip level is fetched
    (by byte range) and becomes visible first, then the rest of the chain
    fills in;
  * completion "hot-swaps" by pointing the material's texture id at the
    pool texture — the analog of MutableBindGroup entry swapping
    (mutable_bind_group.rs:19-29); swaps are applied on the frame thread
    by ``pump()`` so scene mutation stays single-threaded;
  * failures are logged and leave the dummy bound (degrade, never fail).

Pool lifecycle: the preview phase allocates the texture's FULL mip layout
up front (the KTX2 header gives every level's dims), writes only the
smallest mip, and restricts the sampler's mip view to it
(create_texture_with_first_mip_data analog, textures.rs:526-575). The
final phase writes the remaining levels in place and restores the view —
no second allocation, no stranded preview texels, and the device upload
is just the new texels' dirty range.

The port's copy of ``superconductor_tpu/assets/texture_stream.py``: the
swaps set the scene's dirty flags (``Scene._materials_dirty``,
``TexturePool._desc_dirty``) and write through the texel pool's dirty
range, which is what ``scene/upload.py`` ``DeviceScene`` uploads from.
Numpy only: the decode jobs run on the fetch client's executor, and
``pump`` (the only scene mutation) runs on the frame thread.
"""

from __future__ import annotations

import logging
import struct
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..scene.scene import (
    Scene,
    TEXFLAG_SRGB,
    WRAP_REPEAT,
    build_mip_chain,
    mip_skip_for_max_size,
)
from .fetch import FetchClient

log = logging.getLogger(__name__)


@dataclass
class _PendingSwap:
    key: tuple  # (url, srgb) dedup key
    phase: str  # 'preview' | 'final' | 'alias'
    srgb: bool = False
    wrap: int = WRAP_REPEAT
    # preview: full-chain level dims (finest first) + the smallest mip image
    dims: Optional[List[Tuple[int, int]]] = None
    preview_level: int = 0
    preview_image: Optional[np.ndarray] = None
    # final: the full mip chain
    levels: Optional[List[np.ndarray]] = None
    # alias: serve these waiters from the already-loaded texture
    materials: List[tuple] = field(default_factory=list)
    # final: compressed wire bytes behind `levels` (texture_memory_report)
    source_bytes: int = 0


class TextureStreamer:
    """Owns in-flight texture loads; ``pump(scene)`` applies finished ones."""

    def __init__(self, client: FetchClient, max_texture_size: int | None = None):
        self.client = client
        # Optional dimension cap: leading mips beyond it are neither decoded
        # nor fetched into the pool (downscaling_for_max_size analog,
        # textures.rs:609-614 applied at textures.rs:714,989).
        self.max_texture_size = max_texture_size
        self._done: List[_PendingSwap] = []
        self._lock = threading.Lock()
        self._inflight = 0
        # dedup by (url, srgb) -> materials waiting (Shared-future analog,
        # texture_loading.rs:249-336); kept after completion so later
        # requesters are served from the loaded texture, never re-fetched.
        self._by_url: dict = {}
        self._tex_of_key: dict = {}  # key -> pool tex_id (set in pump)
        # keys with a preview swap queued (worker side): a phase-2 failure
        # must NOT drop their waiters — the preview still gets applied, so
        # materials show the low-res level instead of the dummy
        self._preview_pushed: set = set()
        # keys with any texture applied in the pool (pump side): later
        # requesters alias to it instead of waiting for a swap that may
        # never come (and, in the normal flow, see the preview sooner)
        self._served: set = set()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    # ------------------------------------------------------------------
    def request(
        self,
        material_index: int,
        field: str,
        url: str,
        srgb: bool,
        wrap: int = WRAP_REPEAT,
    ) -> None:
        key = (url, srgb)
        waiter = (material_index, field)
        with self._lock:
            if key in self._by_url:
                self._by_url[key].append(waiter)
                if key in self._served:
                    # A texture (preview or final) already exists for this
                    # key: bind this material at the next pump rather than
                    # waiting for a future swap (which never comes if the
                    # final phase failed after the preview).
                    self._done.append(
                        _PendingSwap(key=key, phase="alias", materials=[waiter])
                    )
                return
            self._by_url[key] = [waiter]
            self._inflight += 1
        self.client.submit(self._job, url, srgb, wrap, key)

    def _push(self, swap: _PendingSwap) -> None:
        with self._lock:
            self._done.append(swap)

    def _job(self, url: str, srgb: bool, wrap: int, key) -> None:
        try:
            head = self.client.fetch_bytes_range(url, 0, 4096)
            if head[:12] == b"\xabKTX 20\xbb\r\n\x1a\n":
                self._stream_ktx2(url, srgb, wrap, key, head)
            else:
                data = self.client.fetch_bytes(url)
                from .models import _decode_image

                rgba = _decode_image(data)
                chain = build_mip_chain(rgba)
                skip = mip_skip_for_max_size(
                    chain[0].shape[0], chain[0].shape[1], self.max_texture_size
                )
                self._push(
                    _PendingSwap(
                        key=key, phase="final", srgb=srgb, wrap=wrap,
                        levels=chain[min(skip, len(chain) - 1):],
                        source_bytes=len(data),
                    )
                )
        except Exception:
            with self._lock:
                previewed = key in self._preview_pushed
                if not previewed:
                    self._by_url.pop(key, None)  # allow a retry request
            # if the preview was already queued, keep the waiters: pump()
            # binds them to the low-res preview instead of the dummy
            log.exception(
                "texture stream failed for %s; %s stays", url,
                "preview" if previewed else "dummy",
            )
        finally:
            with self._lock:
                self._inflight -= 1

    def _stream_ktx2(self, url, srgb, wrap, key, head: bytes) -> None:
        """Smallest-mip-first via byte-range reads (textures.rs:784-923)."""
        from .ktx2 import decode_level_u8, parse_ktx2

        width, height = struct.unpack_from("<2I", head, 20)
        levels_n = struct.unpack_from("<I", head, 40)[0] or 1
        dims = [
            (max(1, height >> i), max(1, width >> i)) for i in range(levels_n)
        ]
        # Dimension cap: the skipped top levels are never decoded, and their
        # byte ranges are never fetched in the final pass either.
        skip = min(
            mip_skip_for_max_size(height, width, self.max_texture_size),
            levels_n - 1,
        )
        dims = dims[skip:]
        # level index sits at offset 80
        index = [
            struct.unpack_from("<3Q", head, 80 + i * 24) for i in range(levels_n)
        ]
        # Phase 1: smallest (last) level only.
        off, blen, _ = index[-1]
        smallest = self.client.fetch_bytes_range(url, off, off + blen)
        # Reassemble a buffer where only that level's bytes exist. The full
        # head (not just the level index) is kept: the DFD — which carries
        # the UASTC/ETC1S color model — normally sits inside the first 4 KB.
        fake = bytearray(head)
        # BasisLZ (ETC1S) additionally needs the supercompression global
        # data (codebooks + image descs) before any level can decode.
        sgd_off, sgd_len = struct.unpack_from("<2Q", head, 64)
        if sgd_len and sgd_off + sgd_len > len(fake):
            sgd = self.client.fetch_bytes_range(url, sgd_off, sgd_off + sgd_len)
            fake.extend(b"\0" * (sgd_off + sgd_len - len(fake)))
            fake[sgd_off : sgd_off + sgd_len] = sgd
        fake.extend(b"\0" * max(0, off + blen - len(fake)))
        fake[off : off + blen] = smallest
        # u8 end-to-end: the LDR pool stores display-encoded u8 texels;
        # TEXFLAG_SRGB converts in-shader (one conversion, not two).
        ktx = parse_ktx2(bytes(fake))
        img8 = decode_level_u8(ktx, levels_n - 1)
        with self._lock:
            self._preview_pushed.add(key)
            self._done.append(
                _PendingSwap(
                    key=key, phase="preview", srgb=srgb, wrap=wrap,
                    dims=dims, preview_level=levels_n - 1 - skip,
                    preview_image=img8,
                )
            )

        # Phase 2: everything below the cap.
        data = self.client.fetch_bytes(url)
        ktx = parse_ktx2(data)
        chain = [decode_level_u8(ktx, i) for i in range(skip, levels_n)]
        self._push(
            _PendingSwap(
                key=key, phase="final", srgb=srgb, wrap=wrap, levels=chain,
                source_bytes=len(data),
            )
        )

    # ------------------------------------------------------------------
    def _apply(self, scene: Scene, waiters, tex_id: int) -> int:
        for material_index, field in waiters:
            setattr(scene.materials[material_index], field, tex_id)
        if waiters:
            scene._materials_dirty = True
        return len(waiters)

    def pump(self, scene: Scene) -> int:
        """Apply finished loads (frame thread). Returns number applied."""
        with self._lock:
            done, self._done = self._done, []
        applied = 0
        for swap in done:
            if swap.phase == "alias":
                tex_id = self._tex_of_key.get(swap.key)
                if tex_id is not None:
                    applied += self._apply(scene, swap.materials, tex_id)
                continue
            flags = TEXFLAG_SRGB if swap.srgb else 0
            if swap.phase == "preview":
                tex_id = self._tex_of_key.get(swap.key)
                if tex_id is None:
                    tex_id = scene.textures.allocate_texture(
                        swap.dims, wrap=swap.wrap, flags=flags
                    )
                    self._tex_of_key[swap.key] = tex_id
                scene.textures.write_level(
                    tex_id, swap.preview_level, swap.preview_image
                )
                scene.textures.set_mip_view(tex_id, swap.preview_level, 1)
                with self._lock:
                    self._served.add(swap.key)
                    waiters = list(self._by_url.get(swap.key, ()))
            else:  # final
                scene.textures.source_bytes += swap.source_bytes
                tex_id = self._tex_of_key.get(swap.key)
                dims = [lvl.shape[:2] for lvl in swap.levels]
                if tex_id is not None and self._layout_matches(scene, tex_id, dims):
                    for i, lvl in enumerate(swap.levels):
                        scene.textures.write_level(tex_id, i, lvl)
                    scene.textures.restore_mip_view(tex_id)
                    scene.textures._desc_dirty = True
                else:
                    if tex_id is not None:
                        scene.textures.free_texture(tex_id)
                    tex_id = scene.textures.add_texture(
                        swap.levels, wrap=swap.wrap, flags=flags
                    )
                    self._tex_of_key[swap.key] = tex_id
                # Snapshot waiters atomically with completion: requests
                # before this lock land in the snapshot; requests after see
                # _served and self-serve via an alias swap.
                with self._lock:
                    self._served.add(swap.key)
                    waiters = list(self._by_url.get(swap.key, ()))
            applied += self._apply(scene, waiters, tex_id)
        return applied

    @staticmethod
    def _layout_matches(scene: Scene, tex_id: int, dims) -> bool:
        pool = scene.textures
        base, count = pool._full_view.get(
            tex_id, (pool.tex_mip_base[tex_id], pool.tex_mip_count[tex_id])
        )
        if count != len(dims):
            return False
        return all(
            pool.mip_h[base + i] == h and pool.mip_w[base + i] == w
            for i, (h, w) in enumerate(dims)
        )

    @property
    def idle(self) -> bool:
        with self._lock:
            return self._inflight == 0 and not self._done
