"""The run's look for JAX (whole top-level names) and for a card."""
import importlib.util
import sys
from pathlib import Path

RUN = Path(__file__).resolve().parents[1] / "run.py"


def load_run():
    spec = importlib.util.spec_from_file_location("perfbench_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forbidden_by_whole_top_level_name():
    run = load_run()
    assert run.forbidden_modules(["dpvo_tpu_torch", "dpvo_tpu_torch.ops",
                                  "torch", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["dpvo_tpu.engine", "jax.numpy", "jaxlib",
                                  "flax.linen", "numpy"]) == [
        "dpvo_tpu", "flax", "jax", "jaxlib"]


def test_harness_and_reference_load_no_jax():
    run = load_run()
    import perfbench.harness.cell  # noqa: F401
    import perfbench.reference.engine  # noqa: F401
    mods = [m for m in sys.modules if m.startswith("perfbench")]
    assert mods
    for name in mods:
        src = getattr(sys.modules[name], "__file__", None) or ""
        text = Path(src).read_text() if src.endswith(".py") else ""
        assert "import jax" not in text and "dpvo_tpu." not in text.replace(
            "dpvo_tpu_torch", "")
    assert run.ROOT == RUN.parent.parent


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    run = load_run()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "dpvo_480p.retain", "--seed", "3",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
