"""Host frame producers: image directories and video files.

Counterpart of ``dpvo_tpu/data/stream.py``: a child process decodes frames
and pushes ``(t, image (H, W, 3) BGR uint8, intrinsics [fx fy cx cy])`` onto
a queue, then the sentinel ``(-1, None, None)``.  Undistortion applies when
the calibration carries more than 4 parameters; frames are cropped to a
multiple of 16.  ``cv2`` is imported inside the producers, so this module
imports without it.
"""
from __future__ import annotations

import multiprocessing
import os
from itertools import chain
from pathlib import Path


def image_stream(queue, imagedir, calib, stride, skip=0):
    """Image-directory producer: *.png, *.jpeg, *.jpg in name order."""
    import cv2
    import numpy as np

    calib = np.loadtxt(calib, delimiter=" ")
    fx, fy, cx, cy = calib[:4]

    K = np.eye(3)
    K[0, 0], K[0, 2] = fx, cx
    K[1, 1], K[1, 2] = fy, cy

    img_exts = ["*.png", "*.jpeg", "*.jpg"]
    image_list = sorted(chain.from_iterable(
        Path(imagedir).glob(e) for e in img_exts))[skip::stride]

    for t, imfile in enumerate(image_list):
        image = cv2.imread(str(imfile))
        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])

        h, w, _ = image.shape
        image = image[:h - h % 16, :w - w % 16]

        intrinsics = np.array([fx, fy, cx, cy])
        queue.put((t, image, intrinsics))

    queue.put((-1, None, None))


def video_stream(queue, imagedir, calib, stride, skip=0):
    """Video-file producer; halves the resolution."""
    import cv2
    import numpy as np

    calib = np.loadtxt(calib, delimiter=" ")
    fx, fy, cx, cy = calib[:4]

    K = np.eye(3)
    K[0, 0], K[0, 2] = fx, cx
    K[1, 1], K[1, 2] = fy, cy

    cap = cv2.VideoCapture(imagedir)
    t = 0
    for _ in range(skip):
        cap.read()

    while True:
        for _ in range(stride - 1):
            cap.read()
        ret, image = cap.read()
        if not ret:
            break

        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])

        image = cv2.resize(image, None, fx=0.5, fy=0.5,
                           interpolation=cv2.INTER_AREA)
        h, w, _ = image.shape
        image = image[:h - h % 16, :w - w % 16]

        intrinsics = np.array([fx * 0.5, fy * 0.5, cx * 0.5, cy * 0.5])
        queue.put((t, image, intrinsics))
        t += 1

    cap.release()
    queue.put((-1, None, None))


def spawn_stream(imagedir, calib, stride=1, skip=0, maxsize=8):
    """Start the producer for ``imagedir`` (a video file or an image
    directory) in a child process; returns (queue, process).  The child is
    spawned, not forked: the parent holds PyTorch's threads (and may hold a
    CUDA context)."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue(maxsize=maxsize)
    target = video_stream if os.path.isfile(imagedir) else image_stream
    proc = ctx.Process(target=target,
                       args=(queue, imagedir, calib, stride, skip),
                       daemon=True)
    proc.start()
    return queue, proc
