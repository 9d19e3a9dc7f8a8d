"""K4's contract on the CPU: ``agg_cuda.segment_sums`` (its plain version on
CPU tensors) and ``agg_cuda.segment_sums_ordered`` (the plain version in the
CUDA kernel's summation order) against ``dpvo_tpu.ops.agg_pallas.
segment_sums`` run in interpret mode, on the shapes that stress the kernel's
row slices: runs crossing 64-, 128- and 256-row boundaries, one group
holding every row, a last rank far below g_cap and single-row groups.

Tolerance against JAX: rtol 2e-5 / atol 1e-5 (as tests/test_torch_ops.py
holds the segment sums).  ``segment_sums_ordered`` must equal a numpy
float32 row loop bitwise: the kernel adds each group's rows in row order
from 0, one IEEE fp32 add per row, and so does the row loop.

``segment_case`` is used by ``tests/test_torch_cuda.py`` too, which runs on
a machine without JAX: this module imports JAX only inside its tests.
"""
import numpy as np
import pytest
import torch

from dpvo_tpu_torch.ops import agg_cuda

torch.set_num_threads(1)

E_CPU = 512       # two of the TPU kernel's 256-row blocks
CASES = ["cross64", "cross128", "cross256", "one_group", "low_last_rank",
         "single_rows", "random"]


def segment_case(kind, E=E_CPU, D=98, seed=0):
    """(vals (E, D) fp32, gid (E,) int32 dense sorted ranks, g_cap).

    cross<B>   run heads 5 rows before and 6 after every multiple of B,
               with a few other heads between, so runs cross each boundary
    one_group  every row in group 0
    low_last_rank  three groups, g_cap 4096
    single_rows    one row per group
    random     ranks of E sorted draws from E // 12 ids (about 12 rows a
               group, as at the main path's shapes)
    """
    rng = np.random.default_rng(seed)
    head = np.zeros(E, bool)
    g_cap = 256
    if kind.startswith("cross"):
        B = int(kind[5:])
        for k in range(B, E, B):
            head[[k - 5, k + 6]] = True
        extra = rng.integers(1, E, 8)
        head[extra[extra % B != 0]] = True
    elif kind == "low_last_rank":
        head[[E // 3, E // 2]] = True
        g_cap = 4096
    elif kind == "single_rows":
        head[:] = True
        g_cap = E
    elif kind == "random":
        ids = np.sort(rng.integers(0, max(E // 12, 1), E))
        head[1:] = ids[1:] != ids[:-1]
        g_cap = max(E // 12, 1) + 8
    elif kind != "one_group":
        raise ValueError(kind)
    if E:
        head[0] = True
    gid = (np.cumsum(head) - 1).astype(np.int32)
    # mean 1: a long run's sum does not cancel to near zero, where two
    # summation orders would differ by more than rtol of the result
    vals = rng.normal(1.0, 1.0, size=(E, D)).astype(np.float32)
    return vals, gid, g_cap


def row_loop(vals, gid, g_cap):
    """The row-order reference: one float32 add per row into its group."""
    out = np.zeros((agg_cuda.padded_groups(g_cap), vals.shape[1]),
                   np.float32)
    for r in range(len(gid)):
        if gid[r] < len(out):
            out[gid[r]] += vals[r]
    return out


def pallas_sums(vals, gid, g_cap):
    import jax.numpy as jnp
    from dpvo_tpu.ops import agg_pallas
    return np.asarray(agg_pallas.segment_sums(
        jnp.asarray(vals), jnp.asarray(gid), g_cap, interpret=True))


@pytest.mark.parametrize("kind", CASES)
def test_segment_sums_vs_pallas(kind):
    vals, gid, g_cap = segment_case(kind)
    want = pallas_sums(vals, gid, g_cap)
    got = agg_cuda.segment_sums(torch.from_numpy(vals),
                                torch.from_numpy(gid), g_cap)
    assert got.shape == want.shape == (agg_cuda.padded_groups(g_cap), 98)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    assert not got[int(gid[-1]) + 1:].any()


@pytest.mark.parametrize("kind", CASES)
def test_segment_sums_ordered_is_the_row_loop(kind):
    vals, gid, g_cap = segment_case(kind, seed=1)
    got = agg_cuda.segment_sums_ordered(torch.from_numpy(vals),
                                        torch.from_numpy(gid), g_cap)
    np.testing.assert_array_equal(got.numpy(), row_loop(vals, gid, g_cap))
    np.testing.assert_allclose(got.numpy(), pallas_sums(vals, gid, g_cap),
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("D", [98, 7])
def test_segment_sums_ordered_edges(D):
    """No rows, ranks at or past the padded group count (dropped), and an
    odd width (the kernel's one-column units)."""
    g_cap = 4
    G = agg_cuda.padded_groups(g_cap)
    empty = agg_cuda.segment_sums_ordered(torch.zeros((0, D)),
                                          torch.zeros(0, dtype=torch.int32),
                                          g_cap)
    assert empty.shape == (G, D) and not empty.any()
    rng = np.random.default_rng(2)
    gid = np.repeat(np.arange(G + 3), 2).astype(np.int32)
    vals = rng.normal(size=(len(gid), D)).astype(np.float32)
    got = agg_cuda.segment_sums_ordered(torch.from_numpy(vals),
                                        torch.from_numpy(gid), g_cap)
    np.testing.assert_array_equal(got.numpy(), row_loop(vals, gid, g_cap))
    np.testing.assert_array_equal(
        got.numpy(), agg_cuda.segment_sums_plain(
            torch.from_numpy(vals), torch.from_numpy(gid), g_cap).numpy())
