"""Python backend for the native feature server (csrc/hess_server.cpp).

The C++ server owns the process, sockets, and the reference-compatible
command protocol (ServerSiftGPU.cpp:239-530); it calls into this module for
the actual device compute. The split mirrors the reference architecture where
the server loop wraps the SiftGPU library.

All buffers cross the boundary as bytes in the reference wire layout:
  * keypoints: N x SiftKeypoint = N x 6 float32 (x, y, s, o, response,
    level:u16|type:u16) - SiftGPU.h:108-122.
  * descriptors: N x 128 float32.
"""

from __future__ import annotations

import numpy as np


class ServerBackend:
    """One instance per client connection."""

    def __init__(self, params: str = ""):
        from .config import SiftConfig
        from .detector import HessianSift
        from .matcher import SiftMatcher
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        args = params.split() if params else []
        self.config = SiftConfig.parse_args(args)
        self.sift = HessianSift(self.config)
        self.matcher = SiftMatcher()
        self._feats = None
        self._pending_keys = None

    # ---- detector commands ------------------------------------------------
    def initialize(self) -> int:
        return 1  # jax devices are validated lazily; report full support

    def parse_param(self, params: str) -> None:
        from .config import SiftConfig
        self.config = SiftConfig.parse_args(params.split())
        from .detector import HessianSift
        self.sift = HessianSift(self.config)

    def run_sift_file(self, path: str) -> int:
        try:
            self._feats = self.sift.run(path)
            return 1
        except Exception:
            self._feats = None
            return 0

    def run_sift_data(self, width: int, height: int, data: bytes,
                      gl_format: int, gl_type: int) -> int:
        """COMMAND_RUNSIFT_DATA: raw pixel buffer.

        gl_format/gl_type follow the reference GL enums; we support the
        common cases: luminance u8/f32 and RGB(A) u8.
        """
        try:
            GL_LUMINANCE, GL_RGB, GL_RGBA = 0x1909, 0x1907, 0x1908
            GL_UNSIGNED_BYTE, GL_FLOAT = 0x1401, 0x1406
            if gl_type == GL_FLOAT:
                arr = np.frombuffer(data, np.float32)
            else:
                arr = np.frombuffer(data, np.uint8)
            if gl_format == GL_RGB:
                arr = arr.reshape(height, width, 3)
            elif gl_format == GL_RGBA:
                arr = arr.reshape(height, width, 4)[..., :3]
            else:
                arr = arr.reshape(height, width)
            self._feats = self.sift.run(arr)
            return 1
        except Exception:
            self._feats = None
            return 0

    def _describe_key_buffer(self, buf: np.ndarray,
                             has_orientation: bool) -> int:
        """Describe a (N, 6) SiftKeypoint wire buffer on the last image."""
        try:
            from .describe import describe_keypoints
            num = buf.shape[0]
            cols = buf[:, :4] if has_orientation else buf[:, :3]
            img = self._last_image
            out = describe_keypoints(img, cols, self.config,
                                     has_orientation=has_orientation)
            packed = buf[:, 5].view(np.uint32)
            self._feats = {
                "x": out["x"], "y": out["y"], "sigma": out["sigma"],
                "theta": out["theta"],
                "response": buf[:, 4].copy(),
                "level": (packed & 0xFFFF).astype(np.int32),
                "ftype": (packed >> 16).astype(np.int32),
                "desc": out["desc"],
            }
            return 1
        except Exception:
            return 0

    def run_sift_keys(self, keys: bytes, num: int,
                      has_orientation: int) -> int:
        """COMMAND_RUNSIFT_KEY: describe externally supplied keypoints."""
        buf = np.frombuffer(keys, np.float32).reshape(num, 6).copy()
        return self._describe_key_buffer(buf, bool(has_orientation))

    def set_keypoint_list(self, keys: bytes, num: int,
                          has_orientation: int) -> None:
        """COMMAND_SET_KEYPOINT: stash a keypoint list for the next
        COMMAND_RUNSIFT (reference ServerSiftGPU.cpp:362-377)."""
        buf = np.frombuffer(keys, np.float32).reshape(num, 6).copy()
        self._pending_keys = (buf, bool(has_orientation))

    def run_sift_current(self) -> int:
        """COMMAND_RUNSIFT: re-run on the current image (reference
        ServerSiftGPU.cpp:334-346). Consumes a pending keypoint list from
        COMMAND_SET_KEYPOINT if present, else repeats full detection."""
        if self._pending_keys is not None:
            buf, has_o = self._pending_keys
            self._pending_keys = None
            return self._describe_key_buffer(buf, has_o)
        try:
            self._feats = self.sift.run(self._last_image)
            return 1
        except Exception:
            self._feats = None
            return 0

    @property
    def _last_image(self):
        img = getattr(self.sift, "_last_image", None)
        if img is None:
            raise RuntimeError("no image loaded for keypoint description")
        return img

    def feature_count(self) -> int:
        return 0 if self._feats is None else int(self._feats["x"].shape[0])

    def get_key_vector(self) -> bytes:
        from .features import keypoint_buffer
        if self._feats is None:
            return b""
        return keypoint_buffer(self._feats).tobytes()

    def get_des_vector(self) -> bytes:
        if self._feats is None:
            return b""
        return np.ascontiguousarray(self._feats["desc"],
                                    np.float32).tobytes()

    def save_sift(self, path: str) -> None:
        from .formats import save_sift
        if self._feats is not None:
            save_sift(path, self._feats, self.config)

    def set_max_dimension(self, maxd: int) -> None:
        self.config.max_dim = maxd

    # ---- matcher commands -------------------------------------------------
    def match_set_descriptors_float(self, index: int, num: int,
                                    data: bytes) -> None:
        d = np.frombuffer(data, np.float32).reshape(num, 128)
        self.matcher.set_descriptors(index, d)

    def match_set_descriptors_byte(self, index: int, num: int,
                                   data: bytes) -> None:
        d = np.frombuffer(data, np.uint8).reshape(num, 128)
        self.matcher.set_descriptors(index, d)

    def match_get_match(self, max_match: int, distmax: float,
                        ratiomax: float, mbm: int) -> bytes:
        m = self.matcher.get_sift_match(distmax=distmax, ratiomax=ratiomax,
                                        mutual_best=bool(mbm))
        m = m[:max_match]
        return np.ascontiguousarray(m, np.int32).tobytes()

    def match_set_maxsift(self, n: int) -> None:
        self.matcher.max_sift = n
