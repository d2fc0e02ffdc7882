"""The frozen yardstick against counts worked out by hand for small shapes."""
from harness import flops

DENSE = {"layers": 2, "d_model": 8, "heads": 2, "kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab": 10}


def test_dense_matmul_params_by_hand():
    # a layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8 = 192; MLP 3 x 8 x 16 = 384; head 10 x 8 = 80
    assert flops.dense_matmul_params(DENSE) == 2 * (192 + 384) + 80


def test_dense_train_flops_by_hand():
    # batch 3, seq 5: 6 x 1232 x 15 tokens; attention 4 x D 4 x H 2 x L 2 x B 3 x pairs 15, times 3
    assert flops.causal_pairs(5) == 15
    assert flops.dense_train_flops(DENSE, 3, 5) == 6 * 1232 * 15 + 3 * (4 * 4 * 2 * 2 * 3 * 15)


def test_resnet_forward_flops_by_hand():
    # 32 px (3x3 stem, stride 1, no pool), base 2, one block in one stage, 3 classes:
    # stem 2*32*32*9*3*2; conv1 1x1 2->2, conv2 3x3 2->2, conv3 1x1 2->8, proj 1x1 2->8 at 32x32; head 2*8*3
    m = {"image_size": 32, "base_width": 2, "stages": [1], "classes": 3}
    hw = 32 * 32
    want = 2 * hw * 9 * 3 * 2 + 2 * hw * 2 * 2 + 2 * hw * 9 * 2 * 2 + 2 * hw * 2 * 8 + 2 * hw * 2 * 8 + 2 * 8 * 3
    assert flops.resnet_forward_flops(m) == want


def test_resnet_forward_flops_strided_stage_and_stem():
    # 64 px: 7x7 stride-2 stem to 32, pool to 16; stage 1 strides its first block to 8
    m = {"image_size": 64, "base_width": 1, "stages": [1, 1], "classes": 2}
    want = 2 * 32 * 32 * 49 * 3 * 1  # stem
    want += 2 * 256 * 1 * 1 + 2 * 256 * 9 * 1 * 1 + 2 * 256 * 1 * 4 + 2 * 256 * 1 * 4  # stage 0 at 16x16
    want += 2 * 256 * 4 * 2 + 2 * 64 * 9 * 2 * 2 + 2 * 64 * 2 * 8 + 2 * 64 * 4 * 8  # stage 1: conv1 at 16, rest at 8
    want += 2 * 8 * 2
    assert flops.resnet_forward_flops(m) == want


def test_flash_calls_by_hand():
    # B 1, H 2, KVH 1, S 3, D 4, bf16: 6 live pairs a head, 12 in all
    q, kv, stat = 1 * 3 * 2 * 4 * 2, 1 * 3 * 1 * 4 * 2, 1 * 3 * 2 * 4
    assert flops.flash_call("fwd", 1, 2, 1, 3, 4) == (4 * 4 * 12, 2 * q + 2 * kv + stat)
    assert flops.flash_call("dq", 1, 2, 1, 3, 4) == (6 * 4 * 12, 4 * q + 2 * kv + 2 * stat)
    assert flops.flash_call("dkv", 1, 2, 1, 3, 4) == (8 * 4 * 12, 2 * q + 4 * kv + 2 * stat)


def test_least_time_is_the_larger_bound():
    assert flops.least_time(flops.PEAK_BF16, 0.0) == 1.0
    assert flops.least_time(0.0, 2 * flops.HBM) == 2.0
