"""The window's frames and its keyframe buffer."""
import numpy as np

from conftest import tiny_run
from perfbench.harness import cell, inputs


def test_frames_are_the_rolled_image():
    f = inputs.Frames(2 ** 31 + 11, 8, 16, 4)
    base = np.random.default_rng(2 ** 31 + 11).integers(
        0, 255, size=(8, 32, 3), dtype=np.uint8)
    for t in range(40):
        np.testing.assert_array_equal(
            f.host(t), np.roll(base, -4 * t, axis=1)[:, :16])


def test_buffer_holds_the_window_at_its_rate():
    traffic = dict(warm_frames=30, buffer_fps=320)
    assert cell.buffer_size(traffic, 51) == 16384
    assert cell.buffer_size(traffic, 51) >= 30 + 51 * 320 + 2
    assert cell.buffer_size(traffic, 10) == 4096


def test_a_full_buffer_ends_the_window():
    """A program that fills the keyframe slots before the window closes is
    measured up to that frame, not refused."""
    out, _, _, _ = tiny_run(seconds=600, engine=dict(BUFFER_SIZE=32))
    assert out["attempted"] == 32 - 1 - 12
    assert out["failed"] == 0
    assert out["metrics"]["fps"]["value"] > 0
