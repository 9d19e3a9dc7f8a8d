"""Binary bag-of-words place recognition.

Copy of ``dpvo_tpu/loop_closure/retrieval/dbow.py`` (this package imports
nothing of ``dpvo_tpu``): wraps the repository's C++ library
(``cpp/retrieval.cpp``, the DBoW2/DPRetrieval equivalent: hierarchical
binary k-medians vocabulary + inverted-index database with L1 BoW
scoring) through ctypes.  It loads the built ``cpp/libretrieval.so``; where
that does not load, it compiles ``cpp/retrieval.cpp`` with ``g++`` into
``dpvo_tpu_torch/_build/`` (never into ``cpp/``) and loads that.  There is
no pure-Python fallback: without the library, construction raises.

The vocabulary is trained online from the first frames of the session,
or loaded from a DBoW2 text file.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[3]
_SOURCE = _ROOT / "cpp" / "retrieval.cpp"
_PREBUILT = _ROOT / "cpp" / "libretrieval.so"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"


def _build_lib() -> Path:
    """Compile ``cpp/retrieval.cpp`` into ``_build/`` (named by the
    source's hash; written to a temporary name, then renamed)."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libretrieval_{digest}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SOURCE),
                        "-o", str(tmp)], check=True, capture_output=True)
        os.replace(tmp, out)
    return out


_P8 = ctypes.POINTER(ctypes.c_uint8)
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {    # name: (argtypes, restype)
    "retrieval_create": ([_I, _I], _VP),
    "retrieval_destroy": ([_VP], None),
    "retrieval_train": ([_VP, _P8, _I], None),
    "retrieval_is_trained": ([_VP], _I),
    "retrieval_add": ([_VP, _I, _P8, _I], None),
    "retrieval_query": ([_VP, _P8, _I, _I, _I, ctypes.POINTER(_I),
                         ctypes.POINTER(ctypes.c_float)], None),
    "retrieval_num_images": ([_VP], _I),
    "retrieval_load_vocab": ([_VP, ctypes.c_char_p], _I),
    "retrieval_save_vocab": ([_VP, ctypes.c_char_p], _I),
    "retrieval_num_words": ([_VP], _I),
}


@functools.lru_cache(maxsize=None)
def load_lib():
    """The retrieval library, declared for ctypes: ``cpp/libretrieval.so``,
    or where that does not load here, the one ``_build_lib`` compiles."""
    try:
        lib = ctypes.CDLL(str(_PREBUILT))
    except OSError:
        lib = ctypes.CDLL(str(_build_lib()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


class BinaryBoW:
    """Vocabulary + database over 32-byte binary descriptors."""

    def __init__(self, branching=10, depth=4, train_after=50):
        self.train_after = train_after
        self._pending = []           # descriptors until the vocab trains
        self._lib = load_lib()
        self._h = self._lib.retrieval_create(branching, depth)

    @property
    def trained(self):
        return bool(self._lib.retrieval_is_trained(self._h))

    @staticmethod
    def _ptr(descs):
        descs = np.ascontiguousarray(descs, dtype=np.uint8)
        return descs, descs.ctypes.data_as(_P8)

    def add(self, image_id, descs):
        if descs is None or len(descs) == 0:
            descs = np.zeros((0, 32), np.uint8)
        d, p = self._ptr(descs)
        self._lib.retrieval_add(self._h, int(image_id), p, len(d))
        if not self.trained:
            self._pending.append(d)
            if len(self._pending) >= self.train_after:
                self.train(np.concatenate(self._pending, axis=0))

    def train(self, descs):
        if len(descs) == 0:
            return
        d, p = self._ptr(descs)
        self._lib.retrieval_train(self._h, p, len(d))
        self._pending = []

    def load_vocab(self, path):
        """Load a DBoW2 text-format vocabulary (e.g. the reference's
        pretrained ORBvoc.txt).  Returns the word count.  Frames already
        added are re-indexed with the loaded vocabulary."""
        n = self._lib.retrieval_load_vocab(self._h, str(path).encode())
        if n < 0:
            raise IOError(f"failed to load DBoW2 vocabulary: {path}")
        self._pending = []
        return n

    def save_vocab(self, path):
        """Write the current vocabulary in DBoW2 text format."""
        if self._lib.retrieval_save_vocab(self._h, str(path).encode()) != 0:
            raise IOError(f"failed to save vocabulary to {path}")

    def query(self, descs, qid, min_gap=20):
        """-> (best_image_id or -1, score)."""
        if not self.trained or descs is None or len(descs) == 0:
            return -1, 0.0
        d, p = self._ptr(descs)
        out_id, out_score = ctypes.c_int(-1), ctypes.c_float(0.0)
        self._lib.retrieval_query(self._h, p, len(d), int(qid), int(min_gap),
                                  ctypes.byref(out_id),
                                  ctypes.byref(out_score))
        return out_id.value, out_score.value

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.retrieval_destroy(self._h)
            self._h = None
