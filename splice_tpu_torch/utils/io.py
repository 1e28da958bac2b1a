"""Output utilities (port of splice_tpu/utils/io.py): PNG writes through the
native encoder (utils/pngio.py) with a PIL fallback, and AsyncImageSaver,
which takes the periodic output dump off the training loop's thread."""
from __future__ import annotations

import pathlib
import queue
import sys
import threading
import traceback

import numpy as np
import torch
from PIL import Image

from splice_tpu_torch.utils import pngio
from splice_tpu_torch.utils.metrics import HostCopy


def _to_uint8(image_hwc01) -> np.ndarray:
    arr = np.asarray(image_hwc01)
    if arr.dtype == np.uint8:     # already converted (on the device)
        return arr
    return (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def _write_png(arr_u8: np.ndarray, path: str,
               compress_level: int = 6) -> None:
    data = pngio.encode_png_rgb8(arr_u8, compress_level)
    if data is not None:
        with open(path, "wb") as f:
            f.write(data)
        return
    Image.fromarray(arr_u8).save(path)


def tensor2im(image_01) -> np.ndarray:
    """Float image in [0, 1], [H,W,3] or [1,H,W,3] -> uint8 HWC (values
    clipped, scaled by 255 and truncated, as the reference does); the host
    counterpart of ops.image.tensor2im. Synchronous: a device tensor is
    copied here."""
    if isinstance(image_01, torch.Tensor):
        image_01 = image_01.detach().cpu().numpy()
    arr = np.asarray(image_01)
    if arr.ndim == 4:
        arr = arr[0]
    return _to_uint8(arr)


def save_image(image_hwc01, path: str) -> str:
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    _write_png(tensor2im(image_hwc01), path)
    return path


def save_result(image_hwc01, dataroot: str,
                filename: str = "output.png") -> str:
    """float [H,W,3] in [0,1] -> <dataroot>/out/<filename> PNG
    (reference util.py:55-59)."""
    return save_image(image_hwc01, str(pathlib.Path(dataroot) / "out"
                                       / filename))


class AsyncImageSaver:
    """Background-thread PNG writer so the train loop never blocks on IO.

    save() issues the frame's HostCopy on the caller's thread (a
    non-blocking copy into pinned memory and its event: no
    synchronisation) and queues it; the writer thread waits on that event
    alone, then encodes. Bounded queue of 16: when it is full, save() drops
    the frame (a newer render of the same path lands at the next log
    boundary). Frames that must not be lost (the final output) pass
    must_write=True, which blocks until queued instead. Droppable frames
    encode at zlib level 1 (lossless like every level, about 3x faster
    than 6 on a natural image), must-write ones at 6.

    Any number of threads may call save(); the writer thread is the single
    consumer and the only one doing file IO. A frame that fails is
    reported on stderr and counted in `errors`. close() drains the queue,
    stops the worker and is idempotent; save() after close is a no-op.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=16)
        self._closed = False
        self.errors = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            frame, path, level = item
            try:
                pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
                _write_png(_to_uint8(frame.wait().numpy()), path,
                           compress_level=level)
            except Exception:     # the writer outlives one bad frame
                self.errors += 1
                traceback.print_exc(file=sys.stderr)
            finally:
                self._q.task_done()

    def save(self, image_hwc01, path: str, must_write: bool = False) -> None:
        """Queue an image (numpy, or a tensor on any device; [H, W, 3]
        float in [0, 1] or uint8) for `path`."""
        if self._closed:
            return
        if not must_write and self._q.full():
            return    # drop before copying: a newer frame lands shortly
        frame = HostCopy(torch.as_tensor(image_hwc01))
        if must_write:
            self._q.put((frame, path, 6))
            return
        try:
            self._q.put_nowait((frame, path, 1))
        except queue.Full:
            pass

    def flush(self) -> None:
        self._q.join()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        self._q.put(None)
        self._thread.join(timeout=5)
