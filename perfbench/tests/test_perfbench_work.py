"""The yardstick's counts against hand counts at tiny shapes."""
from perfbench.work import dpvo as w


def test_encoder_flops_by_hand():
    # 16x16 frame: conv1 8x8x32x3x49, layer1 4 convs 8x8x32x32x9, layer2_0
    # 4x4x(64x32x9 + 64x64x9 + 64x32), layer2_1 2 convs 4x4x64x64x9,
    # conv2 4x4xOUTx64; two flops a multiply-add
    out = 128
    macs = (64 * 32 * 3 * 49 + 4 * 64 * 32 * 32 * 9
            + 16 * (64 * 32 * 9 + 64 * 64 * 9 + 64 * 32)
            + 2 * 16 * 64 * 64 * 9 + 16 * out * 64)
    assert w.encoder_flops(16, 16, out) == 2 * macs
    assert w.tracking_flops(16, 16) == (w.encoder_flops(16, 16, 128)
                                        + w.encoder_flops(16, 16, 384))


def test_update_flops_by_hand():
    # one edge, one group: taps 2x9x64x128, projection 882x384, fifteen
    # 384x384 layers, the heads 2x(384x2); the groups' output layers
    per_edge = 2 * 9 * 64 * 128 + 882 * 384 + 15 * 384 * 384 + 4 * 384
    assert w.update_flops(1, 0) == 2 * per_edge
    assert w.update_flops(3, 2) == 2 * (3 * per_edge + 2 * 384 * 384)


def test_least_times():
    # bound by bytes: 3.35e12 bytes take one second
    assert w.bound_s(3.35e12, 0, "bf16") == 1.0
    assert w.bound_s(0, 989e12, "bf16") == 1.0
    assert w.bound_s(0, 67e12, "fp32") == 1.0
    e, k, px = 1000, 100, 5000
    nbytes = (px + k * 9 * 128 * 2 + 882 * 384 * 2 + e * (18 * 4 + 8)
              + e * 384 * 2)
    nops = 2 * e * (2 * 9 * 64 * 128 + 882 * 384)
    assert w.corr_least_s(e, k, px) == max(nbytes / 3.35e12, nops / 989e12)
    k3 = sum(max((e * (2 * 384 * 4 + 4) + 384 * 4 + g * 768 * 4) / 3.35e12,
                 4 * e * 384 / 67e12) for g in (7, 3))
    k4 = 2 * max((e * (62 * 4 + 4) + k * 62 * 4) / 3.35e12, e * 62 / 67e12)
    assert abs(w.agg_least_s(e, 7, 3, 10, k) - (k3 + k4)) < 1e-15
