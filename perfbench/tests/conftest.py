"""Shared pieces of the benchmark's tests: the card marker, and a tiny CPU
version of a cell (the port's engine and the reference at 96x128, 8
patches a frame, fp32) that drives the harness's whole run but the look
for a card."""
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

TINY = dict(
    config=dict(PATCHES_PER_FRAME=8, REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5,
                PATCH_LIFETIME=5, EDGE_CAPACITY=512, image_height=96,
                image_width=128, intrinsics=[64.0, 64.0, 64.0, 48.0],
                MIXED_PRECISION=False),
    engine=dict(BA_WINDOW_CAP=8),
    traffic=dict(warm_frames=12, precompile_max_edges=512,
                 check_share=[0.1, 0.4], trace_offset=10, trace_frames=4))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one); on the "
        "card: python -m pytest -m cuda perfbench/tests")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# the merge regime, every keyframe decision merging, under retain's cell
MERGE = dict(KEYFRAME_THRESH=1e9)


def tiny_run(workload="dpvo_480p.retain", seed=5, seconds=4.0, traffic=None,
             engine=None, **kw):
    """One tiny run of ``workload`` on the CPU, its traffic and engine
    configuration changed by ``traffic`` and ``engine`` -> (result,
    numbers, limits, control numbers)."""
    import torch
    from perfbench.harness import cell
    ov = dict(TINY, traffic={**TINY["traffic"], **(traffic or {})},
              engine={**TINY["engine"], **(engine or {})})
    return cell.run(workload, seed, seconds, False, torch.device("cpu"),
                    time.perf_counter(), overrides=ov, **kw)
