"""The hand-written CUDA kernels have no backward, so their wrappers refuse
autograd on the card (``ops._cuda.refuse_autograd``), and the inference
engine reaches them only with grad mode off.  On the CPU: the helper, and
a drive of the engine whose every kernel-wrapper call and every ``Update``
call is recorded, checking that grad mode is off at each, that the engine's
``Update`` calls (``motion_probe``'s included) take the compact path (K3 on
the card) and that the rollout's take the scatter path.
"""
import numpy as np
import pytest
import torch

from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.models.update import Update
from dpvo_tpu_torch.ops import _cuda, agg_cuda, corr_cuda

torch.set_num_threads(1)
WRAPPERS = ((agg_cuda, "segment_softmax_sums"), (agg_cuda, "segment_sums"),
            (corr_cuda, "corr_enc"), (corr_cuda, "corr_fused"))


def test_refuse_autograd_helper():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="k has no backward"):
        _cuda.refuse_autograd("k", y, x)
    _cuda.refuse_autograd("k", y, x.detach(), None, 3)      # no grad input
    with torch.no_grad():
        _cuda.refuse_autograd("k", y, x)
    with torch.inference_mode():
        _cuda.refuse_autograd("k", x)


@pytest.fixture
def recorded(monkeypatch):
    """Record grad mode at every kernel-wrapper call and, per Update call,
    whether compact metadata came with it."""
    calls, updates = [], []
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, torch.is_grad_enabled()))
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    forward = Update.forward

    def update_forward(self, *a, **kw):
        updates.append((torch.is_grad_enabled(),
                        kw.get("compact_meta") is not None))
        return forward(self, *a, **kw)
    monkeypatch.setattr(Update, "forward", update_forward)
    return calls, updates


def test_engine_runs_kernels_without_grad(recorded):
    """Recipe 4 of the verify notes with the real motion_probe (called at
    every initialisation attempt): every wrapper call without grad, every
    Update call compact."""
    calls, updates = recorded
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=7,
                   OPTIMIZATION_WINDOW=5, PATCH_LIFETIME=5, KEYFRAME_INDEX=4,
                   KEYFRAME_THRESH=1e9, MIXED_PRECISION=False,
                   EDGE_CAPACITY=512, BA_WINDOW_CAP=8)
    slam = DPVO(cfg, network=None, ht=96, wd=128, device="cpu")
    probes = []
    real_probe = slam.motion_probe

    def probe():
        probes.append(real_probe())
        return 100.0                 # random weights: force initialisation
    slam.motion_probe = probe
    base = np.random.default_rng(0).integers(0, 255, (96, 256, 3), np.uint8)
    for t in range(12):
        slam(t, np.ascontiguousarray(np.roll(base, -3 * t, axis=1)[:, :128]),
             np.array([64.0, 64.0, 64.0, 48.0]))
    poses, _ = slam.terminate()
    assert np.isfinite(poses).all()
    assert probes, "motion_probe never ran"
    names = {n for n, _ in calls}
    assert {"segment_softmax_sums", "segment_sums"} <= names
    assert names & {"corr_enc", "corr_fused"}
    assert not any(g for _, g in calls), "a kernel wrapper ran in grad mode"
    assert updates and all(c and not g for g, c in updates), updates


def test_rollout_update_takes_scatter_path(recorded):
    """The training rollout calls Update in grad mode with no metadata, so
    no kernel wrapper is reached."""
    from dpvo_tpu_torch.ops import lie
    from dpvo_tpu_torch.training import rollout as R
    calls, updates = recorded
    rng = np.random.default_rng(0)
    N, M, S, h, w = 3, 2, 2, 8, 12
    K = N * M
    sch = R.build_schedule(N, M, S, rng)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    grid = np.stack(np.meshgrid(np.arange(3.0) - 1, np.arange(3.0) - 1,
                                indexing="xy"))
    ctr = rng.uniform(3, 8, (K, 2, 1, 1))
    patches = t(np.concatenate([ctr + grid[None], np.ones((K, 1, 3, 3))], 1))
    tm = Update(3)
    out = R.vonet_rollout(
        tm, t(rng.normal(size=(K, 384))), t(rng.normal(size=(K, 3, 3, 128))),
        t(rng.normal(size=(N, h, w, 128))), t(rng.normal(size=(N, 2, 3, 128))),
        patches, patches, lie.se3_identity(N),
        t(np.tile([[20.0, 20.0, 6.0, 4.0]], (N, 1))), sch.ii, sch.jj, sch.kk,
        sch.active, sch.fresh, sch.intro, structure_only=False, steps=S, M=M)
    out["flow_err"].sum().backward()
    assert calls == []
    assert updates and all(g and not c for g, c in updates), updates
    assert tm.corr1.weight.grad is not None
