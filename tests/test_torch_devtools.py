"""The port's dev benches and benchmarks (``scripts/dev/*_torch.py``,
``benchmarks/*_torch.py``) on CPU, where they cannot run.

- Each imports here, and its ``main`` exits non-zero naming CUDA without
  a card (none falls back to the CPU); ``lc_match_bench_torch`` is host
  work and has its own tests (tests/test_torch_lc_matcher_quant.py).
- ``roofline_torch``'s counts: K1's operations and least bytes against
  numbers worked out here for windows that all land on one spot; BA's
  algorithm count against its formula written out here; and its count
  in ``roofline.py``'s terms against ``roofline.py``'s own ``ba_point``
  (its timer stubbed) at the same shapes.
- ``compare_scatter_torch``'s dense references against the port's segment
  ops at small shapes, and the check catching a wrong op.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DEV = ROOT / "scripts" / "dev"
sys.path.insert(0, str(DEV))

torch.set_num_threads(1)

TOOLS = [DEV / f"{name}_torch.py" for name in (
    "frame_profile", "bench_profile", "bench_ablate", "update_net_profile",
    "corr_block_profile", "ba_bench", "train_bench", "roofline")] + [
    ROOT / "benchmarks" / f"{name}_torch.py"
    for name in ("compare_scatter", "benchmark_dataloader")]


def load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", TOOLS, ids=lambda p: p.stem)
def test_main_needs_a_card(path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load(path)
    with pytest.raises(SystemExit) as e:
        mod.main(["quick"])
    assert isinstance(e.value.code, str) and "CUDA" in e.value.code


def test_microbench_card_refuses_the_cpu(monkeypatch):
    import microbench_torch as mb
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        mb.card("x")
    assert mb.Timed(1.5, "graph", 1.5).timer == "graph"


def test_roofline_k1_counts():
    from dpvo_tpu_torch.ops import corr_cuda
    rf = load(DEV / "roofline_torch.py")
    E, C, H, W = 5, 128, 32, 40
    Hp, Wp = corr_cuda.padded_hw(H, W)
    Hq, Wq = corr_cuda.padded_hw(H // 4, W // 4)
    g = torch.randn(E, 9, C).to(torch.bfloat16)
    f1 = torch.randn(1, Hp, Wp, C).to(torch.bfloat16)
    f2 = torch.randn(1, Hq, Wq, C).to(torch.bfloat16)
    coords = torch.full((E, 2, 3, 3), 10.3)       # every window at one spot
    ff = torch.zeros(E, dtype=torch.int32)
    out = corr_cuda.corr_fused(g, f1, f2, coords, ff, "v12", torch.bfloat16)
    ops, nbytes = rf.k1_work(g, f1, f2, coords, ff, out)
    # 2 levels x 9 pixels x an 8x8 window of 128-channel dots, x2 per FMA
    assert ops == E * 2 * 9 * 64 * 128 * 2
    # one 8x8 window a level, bf16; g_pre, fp32 coords, int32 frames, out
    assert nbytes == (2 * 64 * C * 2 + E * 9 * C * 2 + E * 18 * 4 + E * 4
                      + out.numel() * 2)


def test_roofline_ba_counts_and_roofline_py(monkeypatch):
    rf = load(DEV / "roofline_torch.py")
    E, k_used = 1000, 500
    counts = rf.ba_work(E, k_used)
    D = 96
    per_iter = (680 * E + 2 * D * D * k_used + D ** 3 // 3 + 2 * D * D)
    assert counts["algorithm"][0] == 2 * per_iter
    assert counts["algorithm"][1] == (2 * (64 * 7 * 4 + 4096 * 27 * 4) + 16
                                      + E * (16 + 24 + 1))
    pytest.importorskip("jax")
    import roofline
    monkeypatch.setattr(roofline, "timed", lambda *a, **k: 1.0)
    for E in (14336, 45312):
        _, flops, nbytes = roofline.ba_point(E)
        assert rf.ba_work(E, k_used)["roofline.py"] == (flops, nbytes)


def test_compare_scatter_references_agree():
    cs = load(ROOT / "benchmarks" / "compare_scatter_torch.py")
    err = cs.errors(300, 40, torch.device("cpu"))
    assert set(err) == set(cs.OPS)
    assert all(e <= cs.TOL for e in err.values()), err


def test_compare_scatter_catches_a_wrong_op(monkeypatch):
    from dpvo_tpu_torch.ops import scatter
    cs = load(ROOT / "benchmarks" / "compare_scatter_torch.py")
    monkeypatch.setattr(scatter, "scatter_sum",
                        lambda src, idx, S: src.new_zeros((S,) + src.shape[1:]))
    err = cs.errors(300, 40, torch.device("cpu"))
    assert err["scatter_sum"] > 1e-2
    ref = cs.dense("scatter_max", np.array([[1.0], [3.0], [2.0]]),
                   np.array([0, 0, 2]), 3)
    assert ref.tolist() == [[3.0], [-np.inf], [2.0]]
