"""The loop-closure matcher bench on the port's matchers
(``scripts/dev/lc_match_bench_torch.py``), on CPU.

tests/test_lc_matcher_quant.py's four contracts, on the port's
``long_term._match``, ``_sift_descriptors``,
``retrieval_dbow._orb_descriptors`` and ``optim_utils.ransac_umeyama``:
(a) the ORB path recovers the drift Sim3 within usable absolute bounds and
within 2x the oracle matcher's errors; (b) the SIFT default reaches at
least the oracle's inliers with a far tighter Sim3; (c) SIFT survives the
combined stress scenario and (d) each stress alone.  Then the default
scenario's every number against the JAX bench's (``lc_match_bench.py``),
to 1e-6: both run the same numpy and OpenCV code.
"""
import os.path as osp
import sys

import pytest

pytest.importorskip("cv2")

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "scripts", "dev"))


def test_orb_sim3_recovery_vs_oracle():
    import lc_match_bench_torch as B

    res = B.run(seed=7, verbose=False)
    orb, oracle = res["orb"], res["oracle"]
    assert orb is not None, "ORB path failed to produce a Sim3"
    assert oracle is not None, "oracle path failed (bench geometry bug)"
    assert orb["inliers"] >= 50
    assert orb["rot_err_deg"] < 2.5
    assert orb["t_err"] < 0.2
    assert orb["scale_err_pct"] < 2.0
    assert orb["rot_err_deg"] < max(2.0 * oracle["rot_err_deg"], 1.5)
    assert orb["scale_err_pct"] < max(2.0 * oracle["scale_err_pct"], 1.0)


def test_sift_default_beats_oracle_ceiling():
    import lc_match_bench_torch as B

    res = B.run(seed=7, verbose=False)
    sift, oracle = res["sift"], res["oracle"]
    assert sift is not None, "SIFT path failed to produce a Sim3"
    assert oracle is not None, "oracle path failed (bench geometry bug)"
    assert sift["inliers"] >= oracle["inliers"]
    assert sift["inlier_rate"] > 0.9
    assert sift["rot_err_deg"] < 0.1
    assert sift["t_err"] < 0.01
    assert sift["scale_err_pct"] < 0.1


def test_sift_survives_stress_scenarios():
    import lc_match_bench_torch as B

    res = B.run(seed=7, verbose=False, illum=(0.6, -25.0, 1.4),
                roll_deg=15.0, two_plane=True)
    sift = res["sift"]
    assert sift is not None, "SIFT failed under combined stress"
    assert sift["inliers"] >= 100
    assert sift["inlier_rate"] > 0.8
    assert sift["rot_err_deg"] < 0.2
    assert sift["t_err"] < 0.02
    assert sift["scale_err_pct"] < 0.5


def test_sift_survives_individual_stresses():
    import lc_match_bench_torch as B

    for kw in (dict(illum=(0.6, -25.0, 1.4)), dict(roll_deg=15.0),
               dict(two_plane=True)):
        res = B.run(seed=7, verbose=False, **kw)
        sift = res["sift"]
        assert sift is not None, f"SIFT failed under {kw}"
        assert sift["inliers"] >= 100, kw
        assert sift["rot_err_deg"] < 0.2, kw
        assert sift["t_err"] < 0.02, kw
        assert sift["scale_err_pct"] < 0.5, kw


def test_numbers_equal_the_jax_bench():
    import lc_match_bench as J
    import lc_match_bench_torch as B

    got, want = B.run(seed=7, verbose=False), J.run(seed=7, verbose=False)
    assert set(got) == set(want) == {"orb", "sift", "oracle"}
    for name in want:
        assert (got[name] is None) == (want[name] is None), name
        assert set(got[name]) == set(want[name])
        for k, v in want[name].items():
            assert got[name][k] == pytest.approx(v, rel=1e-6, abs=1e-6), \
                (name, k)
