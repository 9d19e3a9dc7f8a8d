"""Process-isolated place-recognition frontend.

Copy of ``dpvo_tpu/loop_closure/retrieval/retrieval_dbow.py`` (this
package imports nothing of ``dpvo_tpu``): ORB features + BoW database run
in a spawned child process with in/out queues so retrieval never blocks
the tracking loop; detections require ``num_repeat`` consecutive hits and
are NMS-suppressed against previous closures.  Keyframe-index remapping
mirrors the engine's keyframe removals (``keyframe`` is called as each
merge applies).
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import time

import numpy as np

NMS = 50  # suppression window vs previous closures (ref :14)


def _orb_descriptors(image, n_features=1000):
    import cv2
    orb = cv2.ORB_create(nfeatures=n_features)
    gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY) \
        if image.ndim == 3 else image
    kps, descs = orb.detectAndCompute(gray, None)
    if descs is None:
        descs = np.zeros((0, 32), np.uint8)
    pts = np.array([k.pt for k in kps], np.float32).reshape(-1, 2)
    return pts, descs


def _dbow_loop(in_queue, out_queue, min_gap, vocab_path=None):
    """Child process: consume frames, produce (query_id, match_id, score)
    (ref retrieval_dbow.py:18-26)."""
    from .dbow import BinaryBoW
    bow = BinaryBoW()
    if vocab_path:
        # pretrained DBoW2 text vocabulary (ref retrieval_dbow.py:31-34
        # loads ORBvoc.txt) — no online cold-start window
        bow.load_vocab(vocab_path)
    while True:
        item = in_queue.get()
        if item is None:
            break
        idx, image = item
        _, descs = _orb_descriptors(image)
        bow.add(idx, descs)
        match, score = bow.query(descs, idx, min_gap)
        out_queue.put((idx, match, float(score)))


class RetrievalDBOW:
    def __init__(self, min_gap=20, thresh=0.04, num_repeat=3,
                 vocab_path=None):
        self.min_gap = min_gap
        self.thresh = thresh
        self.num_repeat = num_repeat

        ctx = mp.get_context("spawn")
        self.in_queue = ctx.Queue(maxsize=32)
        self.out_queue = ctx.Queue()
        self.proc = ctx.Process(target=_dbow_loop,
                                args=(self.in_queue, self.out_queue,
                                      min_gap, vocab_path), daemon=True)
        self.proc.start()

        self.found = []            # accepted closures [(i, j)]
        self.hits = []             # consecutive-hit buffer
        self.remap = []            # keyframe index remapping

    def __call__(self, image, n):
        """Submit frame n (ref retrieval_dbow.py:54-66)."""
        while len(self.remap) <= n:
            self.remap.append(len(self.remap))
        self.in_queue.put((n, np.ascontiguousarray(image)))

    def keyframe(self, k):
        """Record keyframe removal: indices > k shift down by 1
        (ref retrieval_dbow.py:54-66)."""
        for i in range(len(self.remap)):
            if self.remap[i] is not None and self.remap[i] > k:
                self.remap[i] -= 1
            elif self.remap[i] == k:
                self.remap[i] = None

    def _remapped(self, i):
        r = self.remap[i] if i < len(self.remap) else i
        return r

    def detect_loop(self, thresh=None, num_repeat=None):
        """Drain results; return (i, j) when ``num_repeat`` consecutive
        frames matched near the same place (ref retrieval_dbow.py:79-114).
        """
        thresh = self.thresh if thresh is None else thresh
        num_repeat = self.num_repeat if num_repeat is None else num_repeat

        while not self.out_queue.empty():
            qid, match, score = self.out_queue.get()
            if match < 0 or score < thresh:
                self.hits = []
                continue
            self.hits.append((qid, match))
            if len(self.hits) >= num_repeat:
                qs = [h[0] for h in self.hits[-num_repeat:]]
                ms = [h[1] for h in self.hits[-num_repeat:]]
                if max(qs) - min(qs) <= num_repeat + 1 \
                        and max(ms) - min(ms) <= 2 * num_repeat + 2:
                    i, j = self.hits[-1]
                    # NMS against previous closures (ref :107)
                    if all(abs(i - pi) > NMS or abs(j - pj) > NMS
                           for pi, pj in self.found):
                        self.found.append((i, j))
                        self.hits = []
                        ri, rj = self._remapped(i), self._remapped(j)
                        if ri is not None and rj is not None:
                            return ri, rj
        return None

    def close(self):
        self.in_queue.put(None)
        # drain what the child still writes, so that it can exit
        deadline = time.monotonic() + 10.0
        while self.proc.is_alive() and time.monotonic() < deadline:
            try:
                self.out_queue.get(timeout=0.1)
            except queue.Empty:
                pass
        self.proc.join(timeout=2.0)
        if self.proc.is_alive():
            self.proc.terminate()
