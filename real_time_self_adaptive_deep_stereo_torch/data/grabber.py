"""Camera grabber runtime for the live demo.

Port of ``real_time_self_adaptive_deep_stereo_tpu/data/grabber.py``,
counterpart of reference ``Demo/grabber.py``: an ``ImageGrabber`` thread
ABC with a decorator-based camera factory (grabber.py:11-29,36-92),
feeding stereo pairs into a bounded queue.

Cameras:

* ``folder`` replays rectified image pairs from a CSV list or two
  directories, read by the port's :func:`~.readers.load_image`; it runs
  headless (the tests, and the demo on a machine without a camera);
* ``zed``: ZED/ZED-Mini over the ``pyzed`` SDK, registered only where the
  SDK imports (the reference's camera, grabber.py:99-146);
* ``opencv``: any ``cv2.VideoCapture`` device producing side-by-side
  stereo frames, registered only where ``cv2`` imports.
"""

from __future__ import annotations

import abc
import os
import queue
import threading
import time
from typing import Dict, Optional, Tuple, Type

import numpy as np

__all__ = ["ImageGrabber", "register_camera", "get_camera", "CAMERA_FACTORY"]

CAMERA_FACTORY: Dict[str, Type["ImageGrabber"]] = {}


def register_camera(name: str):
    """Class decorator registering a camera under ``name``."""

    def wrap(cls):
        CAMERA_FACTORY[name] = cls
        return cls

    return wrap


def get_camera(name: str, out_queue: queue.Queue, **kwargs) -> "ImageGrabber":
    if name not in CAMERA_FACTORY:
        raise KeyError(
            f"unknown camera {name!r}; available: {sorted(CAMERA_FACTORY)}"
        )
    return CAMERA_FACTORY[name](out_queue, **kwargs)


class ImageGrabber(threading.Thread, abc.ABC):
    """Grabs stereo pairs and pushes ``np.stack([left, right])`` into a
    bounded queue, then ``None`` at the end of the stream."""

    #: live sources drop frames when the consumer lags (the reference
    #: demo's Queue(1) semantics); file-replay sources override this to
    #: block instead, so that every frame is adapted on, even while the
    #: first step captures its graphs (a folder is not a real-time source).
    drop_when_full = True

    def __init__(self, out_queue: queue.Queue, fps_cap: float = 0.0):
        super().__init__(daemon=True)
        self.queue = out_queue
        self.fps_cap = fps_cap
        # not `_stop`, which threading.Thread uses
        self._stop_evt = threading.Event()

    @abc.abstractmethod
    def grab(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Return (left, right) uint8/float RGB arrays or None at end."""

    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        period = 1.0 / self.fps_cap if self.fps_cap > 0 else 0.0
        try:
            while not self._stop_evt.is_set():
                t0 = time.perf_counter()
                pair = self.grab()
                if pair is None:
                    break
                item = np.stack([pair[0], pair[1]])
                while not self._stop_evt.is_set():
                    try:
                        self.queue.put(item, timeout=1.0)
                        break
                    except queue.Full:
                        if self.drop_when_full:
                            break  # drop the frame (live-camera lag)
                if period:
                    dt = time.perf_counter() - t0
                    if dt < period:
                        time.sleep(period - dt)
        finally:
            # the end-of-stream marker is never dropped: the consumer may
            # still be busy with the queue full, so retry until it is
            # taken or the grabber is stopped
            while True:
                try:
                    self.queue.put(None, timeout=0.5)
                    break
                except queue.Full:
                    if self._stop_evt.is_set():
                        break


@register_camera("folder")
class FolderGrabber(ImageGrabber):
    """Replays image pairs from a CSV list (left,right per line) or two
    directories; optionally loops forever. Blocks on a full queue unless
    ``fps_cap > 0`` asks for real-time emulation, which drops as a live
    camera does."""

    def __init__(
        self,
        out_queue: queue.Queue,
        list_file: Optional[str] = None,
        left_dir: Optional[str] = None,
        right_dir: Optional[str] = None,
        loop: bool = False,
        **kw,
    ):
        super().__init__(out_queue, **kw)
        from real_time_self_adaptive_deep_stereo_torch.data.readers import read_list_file

        if list_file:
            left, right, _, _ = read_list_file(list_file)
            self.pairs = list(zip(left, right))
        else:
            ls = sorted(os.listdir(left_dir))
            rs = sorted(os.listdir(right_dir))
            self.pairs = [
                (os.path.join(left_dir, a), os.path.join(right_dir, b))
                for a, b in zip(ls, rs)
            ]
        self.loop = loop
        self._idx = 0
        self.drop_when_full = self.fps_cap > 0

    def grab(self):
        from real_time_self_adaptive_deep_stereo_torch.data.readers import load_image

        if self._idx >= len(self.pairs):
            if not self.loop:
                return None
            self._idx = 0
        l, r = self.pairs[self._idx]
        self._idx += 1
        return load_image(l), load_image(r)


try:  # pragma: no cover - requires the ZED SDK
    import pyzed.sl as _sl

    @register_camera("zed")
    class ZedGrabber(ImageGrabber):
        """ZED / ZED-Mini stereo camera via the pyzed SDK."""

        def __init__(self, out_queue: queue.Queue, resolution: str = "HD720", **kw):
            super().__init__(out_queue, **kw)
            init = _sl.InitParameters()
            init.camera_resolution = getattr(_sl.RESOLUTION, resolution)
            self.cam = _sl.Camera()
            if self.cam.open(init) != _sl.ERROR_CODE.SUCCESS:
                raise RuntimeError("failed to open ZED camera")
            self._left = _sl.Mat()
            self._right = _sl.Mat()

        def grab(self):
            if self.cam.grab() != _sl.ERROR_CODE.SUCCESS:
                return None
            self.cam.retrieve_image(self._left, _sl.VIEW.LEFT)
            self.cam.retrieve_image(self._right, _sl.VIEW.RIGHT)
            l = self._left.get_data()[..., 2::-1].astype(np.float32)
            r = self._right.get_data()[..., 2::-1].astype(np.float32)
            return l, r

except ImportError:
    pass


try:  # pragma: no cover - requires cv2 and a device
    import cv2 as _cv2

    @register_camera("opencv")
    class OpenCVGrabber(ImageGrabber):
        """Side-by-side stereo over any cv2.VideoCapture device."""

        def __init__(self, out_queue: queue.Queue, device: int = 0, **kw):
            super().__init__(out_queue, **kw)
            self.cap = _cv2.VideoCapture(device)
            if not self.cap.isOpened():
                raise RuntimeError(f"cannot open capture device {device}")

        def grab(self):
            ok, frame = self.cap.read()
            if not ok:
                return None
            frame = frame[..., 2::-1].astype(np.float32)
            w = frame.shape[1] // 2
            return frame[:, :w], frame[:, w:]

except ImportError:
    pass
