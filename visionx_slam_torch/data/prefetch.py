"""Decode-ahead for the pure-Python loader (``data/tum.py`` on
``data/png.py``), the counterpart of ``native_loader.NativePrefetcher``
where libpng is missing.

Worker threads run ``tum.load_rgb_gray`` and ``tum.load_depth_m`` up to
``queue_depth`` frames ahead of the consumer. A worker spends most of a
frame where the interpreter lock is released (the file read,
``zlib.decompress``, numpy's large ufuncs), so it overlaps a consumer that
gives the lock up at every torch call. The workers make no torch or CUDA
call: lazy library loads are not safe under racing threads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from . import tum

THREAD_PREFIX = "vxs-decode"


class PythonPrefetcher:
    """Bounded threaded decode over (rgb, depth) path pairs.

    Iterate to receive (gray u8 [H,W], depth f32 [H,W]) in dataset order,
    bit-equal to the two loaders, while at most ``queue_depth`` frames are
    decoded ahead. A worker's exception is raised at the frame it belongs
    to. ``ready`` counts the frames that were decoded already when the
    consumer asked for them."""

    def __init__(self, rgb_paths, depth_paths, queue_depth: int = 4,
                 n_threads: int = 2):
        self._todo = iter(zip(rgb_paths, depth_paths))
        self._pool = ThreadPoolExecutor(max_workers=n_threads,
                                        thread_name_prefix=THREAD_PREFIX)
        self._window: deque = deque()
        self._lock = threading.Lock()
        self._decode_s = 0.0
        self.ready = 0
        for _ in range(max(queue_depth, 1)):
            self._submit()

    def _decode(self, rgb_path: str, depth_path: str):
        t0 = time.perf_counter()
        frame = tum.load_rgb_gray(rgb_path), tum.load_depth_m(depth_path)
        dt = time.perf_counter() - t0
        with self._lock:
            self._decode_s += dt
        return frame

    def _submit(self) -> None:
        paths = next(self._todo, None)
        if paths is not None:
            self._window.append(self._pool.submit(self._decode, *paths))

    def __iter__(self):
        while self._window:
            fut = self._window.popleft()
            self.ready += fut.done()
            frame = fut.result()
            self._submit()      # keep the window full while the frame is used
            yield frame

    def ahead(self) -> int:
        """Frames of the window decoded and not yet taken."""
        return sum(f.done() for f in self._window)

    def decode_seconds(self) -> float:
        """The workers' summed decode time so far (overlapped with the
        consumer)."""
        with self._lock:
            return self._decode_s

    def close(self) -> None:
        """Cancel the frames not started and join the workers."""
        self._window.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)
