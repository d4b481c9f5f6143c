"""The rule that sends a kernel call to its tensor-core or its FFMA variant,
and the attention work count that ``chip_smoke.py`` turns into a bound.

Both are plain functions of dtype and shape, so they run on the CPU:

* ``moe_gmm``: bf16 with D and F multiples of 8 (TMA's 16-byte global
  strides) goes to the wgmma kernel, everything else to the FFMA kernel;
  its backward by the same rule.
* ``flash_attention``: bf16 goes to the wgmma kernel, fp32 to the FFMA one;
  its backward: bf16 (every head_dim up to 256) to the wgmma kernels
  (``"tc"``), fp32 to the FFMA kernels (``"ffma"``); no other name is a
  variant.  ``bwd_head_splits`` splits a KV group's query heads over dK/dV
  blocks of the wide (head_dim > 128) kernel where its grid is under one
  wave.
* ``decode_attention``: bf16 with G = H / Kv <= 16 goes to the mma.sync
  kernel, everything else (fp32) to the FFMA kernel; ``tc_splits`` cuts W
  into whole tiles within one wave of blocks.
* ``visible_pairs``: the (query, key) pairs the plain version's mask lets
  through, counted in closed form; it must equal the mask's sum exactly.
"""
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import visible, visible_pairs
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel

bf16, f32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,D,F,want", [
    (bf16, 5120, 8192, "tc"),   # Llama-4-Scout gate/up
    (bf16, 8192, 5120, "tc"),   # and down
    (bf16, 520, 136, "tc"),     # multiples of 8, not of 64
    (bf16, 8, 8, "tc"),
    (bf16, 100, 96, "ffma"),    # D: a 200-byte row stride
    (bf16, 64, 130, "ffma"),    # F: a 260-byte row stride
    (bf16, 33, 7, "ffma"),
    (f32, 5120, 8192, "ffma"),  # fp32 never takes the bf16 tensor cores
    (f32, 64, 64, "ffma"),
])
def test_moe_gmm_route(dtype, D, F, want):
    """The backward (dx, dw) reads the same tensors through TMA, so it
    takes the forward's rule."""
    assert gmm_kernel.route(dtype, D, F) == want
    assert gmm_kernel.route_bwd(dtype, D, F) == want


@pytest.mark.parametrize("dtype,D,F,variant,match", [
    (bf16, 100, 96, "tc", "multiples of 8"),
    (f32, 64, 64, "tc", "multiples of 8"),
    (bf16, 64, 64, "wgmma", "unknown variant"),
    (bf16, 64, 64, "", "unknown variant"),
])
def test_moe_gmm_backward_refuses_before_launch(dtype, D, F, variant,
                                                match):
    """The backward's launcher refuses a variant its route would not send
    these inputs to, before anything is built or launched."""
    x = torch.zeros((2, 8, D), dtype=dtype)
    w = torch.zeros((2, D, F), dtype=dtype)
    dy = torch.zeros((2, 8, F), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        gmm_kernel.launch_bwd(x, w, dy, variant)


@pytest.mark.parametrize("E,C,D,F,want", [
    (16, 320, 5120, 8192, (1280, 20480)),  # Scout's train gate/up
    (16, 320, 8192, 5120, (2048, 20480)),  # and down
    (16, 8, 5120, 8192, (640, 20480)),     # decode-sized C: 64-wide dx tiles
    (5, 330, 1536, 768, (180, 180)),       # ragged C on 160
    (1, 1, 64, 64, (1, 1)),
])
def test_moe_gmm_backward_tiles(E, C, D, F, want):
    """The persistent backward's tiles: dx^T in 128 x 160 (C > 64: Scout's
    C = 320 in exactly two) or 128 x 64, dw in 128 x 256."""
    assert gmm_kernel.bwd_tc_tiles(E, C, D, F) == want


@pytest.mark.parametrize("dtype,hd,want", [
    (bf16, 128, "tc"), (bf16, 256, "tc"), (bf16, 64, "tc"), (bf16, 16, "tc"),
    (bf16, 48, "tc"), (bf16, 192, "tc"),
    (f32, 128, "ffma"), (f32, 256, "ffma"), (f32, 16, "ffma"),
])
def test_flash_attention_route(dtype, hd, want):
    assert flash_kernel.route(dtype, hd) == want


@pytest.mark.parametrize("dtype", [bf16, f32])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 96, 112, 128, 192, 256])
def test_flash_backward_route(dtype, hd):
    want = "tc" if dtype == bf16 and hd <= 256 else "ffma"
    assert flash_kernel.route_bwd(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd", [(f32, 192), (f32, 256), (f32, 128),
                                      (f32, 64)])
def test_flash_backward_tensor_core_variant_refuses_before_launch(dtype, hd):
    """The wgmma kernels take bf16 (head_dim <= 256) only: asked for
    anything else they raise before anything is built or launched."""
    q = torch.zeros((1, 8, 2, hd), dtype=dtype)
    k = torch.zeros((1, 8, 1, hd), dtype=dtype)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="head_dim <= 256"):
        flash_kernel.launch_bwd(q, k, k, q, lse, q, "tc", causal=True,
                                window=0, chunk_attn=0)


@pytest.mark.parametrize("B,Skv,Kv,H,hd,want", [
    (1, 4096, 1, 10, 256, 5),    # RecurrentGemma-2B's train microbatch
    (2, 4096, 1, 10, 256, 5),    # 128 blocks: still under a wave
    (1, 8192, 1, 10, 256, 5),
    (1, 1000, 1, 10, 256, 10),   # 16 blocks: two waves need more than G
    (1, 2000, 1, 10, 256, 10),   # 32 blocks: 5 runs make 160, under two waves
    (1, 3000, 1, 10, 256, 10),   # 47 blocks: 5 runs make 235, still short
    (1, 64, 2, 4, 192, 2),       # G 2 caps the runs
    (1, 5000, 1, 1, 256, 1),     # MHA: nothing to split
    (4, 4096, 8, 16, 128, 1),    # InternLM2: the hd <= 128 pair never splits
    (1, 64, 1, 10, 128, 1),
    (1, 4096, 8, 16, 256, 1),    # 512 blocks: a wave already
])
def test_flash_backward_head_splits(B, Skv, Kv, H, hd, want):
    """The wide dK/dV kernel's head splits on an H100's 132 SMs: under one
    wave of the B Kv Skv / 64 blocks, the fewest equal runs of the group's
    heads (a divisor of G) that make two waves, or G; 1 once the blocks
    fill a wave, and always at head_dim <= 128."""
    splits = flash_kernel.bwd_head_splits(B, Skv, Kv, H, hd, 132)
    assert splits == want
    G = H // Kv
    blocks = B * Kv * -(-Skv // flash_kernel.WIDE_KEYS)
    assert G % splits == 0
    if hd <= 128 or blocks >= 132:
        assert splits == 1
    else:
        assert blocks * splits >= 2 * 132 or splits == G
        assert all(blocks * d < 2 * 132 for d in range(1, splits)
                   if G % d == 0)


@pytest.mark.parametrize("variant", ["mma", "wgmma", "TC", ""])
def test_flash_backward_refuses_unknown_variant(variant):
    """Only ``"tc"`` and ``"ffma"`` are backward variants: any other name
    raises before anything is built or launched, on inputs ``"tc"`` takes."""
    q = torch.zeros((1, 8, 2, 128), dtype=bf16)
    k = torch.zeros((1, 8, 1, 128), dtype=bf16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="unknown variant"):
        flash_kernel.launch_bwd(q, k, k, q, lse, q, variant, causal=True,
                                window=0, chunk_attn=0)


@pytest.mark.parametrize("dtype,G,hd,want", [
    (bf16, 2, 128, "tc"),    # InternLM2-1.8B
    (bf16, 5, 128, "tc"),    # Llama-4-Scout
    (bf16, 10, 256, "tc"),   # RecurrentGemma-2B
    (bf16, 8, 112, "tc"),    # Kimi-K2
    (bf16, 1, 192, "tc"),    # xLSTM
    (bf16, 16, 64, "tc"),    # the padded row count itself
    (bf16, 1, 16, "tc"),
    (bf16, 17, 128, "ffma"),  # more heads than the 16 padded rows
    (bf16, 32, 64, "ffma"),
    (f32, 2, 128, "ffma"),   # fp32 never takes the bf16 tensor cores
    (f32, 10, 256, "ffma"),
])
def test_decode_attention_route(dtype, G, hd, want):
    assert decode_kernel.route(dtype, G, hd) == want


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_catalog_config_decodes_on_the_tensor_cores_in_bf16(arch):
    cfg = get_config(arch)
    G = cfg.num_heads // cfg.num_kv_heads
    assert decode_kernel.route(bf16, G, cfg.head_dim) == "tc"


@pytest.mark.parametrize("B,Kv,W,hd,want", [
    (8, 8, 1174, 128, (320, 4)),    # InternLM2 / Scout served decode
    (32, 8, 32768, 128, (32768, 1)),  # long decode: one split, no combine
    (4, 1, 2048, 256, (64, 32)),    # RecurrentGemma served ring
    (1, 1, 5, 16, (64, 1)),         # the split draft's shape
])
def test_decode_attention_tc_splits(B, Kv, W, hd, want):
    assert decode_kernel.tc_splits(B, Kv, W, 132, hd) == want


@pytest.mark.parametrize("B,Kv", [(1, 1), (4, 1), (8, 8), (32, 8), (64, 8),
                                  (3, 5)])
@pytest.mark.parametrize("W,hd", [(5, 16), (200, 64), (1174, 128),
                                  (2048, 256), (32768, 112)])
def test_decode_attention_tc_splits_stay_within_one_wave(B, Kv, W, hd):
    """Splits are whole 64-slot tiles that cover W, none empty, and the
    blocks fit one wave (every block resident at once) unless B * Kv alone
    exceeds it."""
    split, n = decode_kernel.tc_splits(B, Kv, W, 132, hd)
    assert split % decode_kernel.TILE == 0
    assert (n - 1) * split < W <= n * split
    wave = decode_kernel.tc_blocks_per_sm(hd) * 132
    assert B * Kv * n <= wave or n == 1


@pytest.mark.parametrize("hd,want", [(64, 3), (112, 2), (128, 2), (192, 1),
                                     (256, 1)])
def test_decode_attention_tc_blocks_per_sm(hd, want):
    """Shared memory per block (a 3-stage ring of 64-slot K and V tiles and
    16 query rows, bf16 rows padded by 16 bytes) against 228 KB an SM."""
    assert decode_kernel.tc_blocks_per_sm(hd) == want
    assert decode_kernel.tc_smem_bytes(hd) <= 232448  # one block's limit


def test_variant_launch_refuses_what_its_route_does_not_send():
    """Asking the tensor-core variant for what the rule sends elsewhere, or
    for a base TMA cannot address, raises before anything is built or
    launched."""
    x = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="tensor-core"):
        gmm_kernel.launch(x, torch.zeros((1, 64, 8)), "tc")
    w = torch.zeros((1, 64, 8), dtype=bf16)
    x = torch.zeros(1 + 2 * 64, dtype=bf16)[1:].view(1, 2, 64)  # 2-byte offset
    with pytest.raises(ValueError, match="16-byte"):
        gmm_kernel.launch(x, w, "tc")
    q = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="tensor-core"):
        flash_kernel.launch(q, q, q, "tc", causal=True, window=0,
                            chunk_attn=0)
    q = torch.zeros((1, 1, 4, 64))
    cache = torch.zeros((1, 8, 1, 64))
    with pytest.raises(ValueError, match="tensor-core"):
        decode_kernel.launch(q, cache, cache, torch.ones(1, dtype=torch.int32),
                             0, "tc", ring=False, chunk_attn=0)
    q = torch.zeros((1, 1, 17, 64), dtype=bf16)
    cache = torch.zeros((1, 8, 1, 64), dtype=bf16)
    with pytest.raises(ValueError, match="G <= 16"):
        decode_kernel.launch(q, cache, cache, torch.ones(1, dtype=torch.int32),
                             1, "tc", ring=False, chunk_attn=0)


@pytest.mark.parametrize("Sq,Skv,causal,window,chunk", [
    (1, 1, True, 0, 0),
    (64, 64, True, 0, 0),
    (100, 300, False, 0, 0),
    (100, 250, True, 0, 0),
    (300, 120, True, 0, 0),
    (257, 257, True, 0, 100),    # chunked
    (257, 257, False, 0, 64),    # chunked, not causal
    (300, 300, True, 33, 0),     # window
    (129, 200, False, 64, 0),    # window without causal: keys ahead too
    (300, 300, True, 48, 100),   # window and chunk together
    (3072, 3072, True, 2048, 0),  # RecurrentGemma-2B's served prefill
])
def test_visible_pairs_counts_the_plain_mask(Sq, Skv, causal, window, chunk):
    masks = dict(causal=causal, window=window, chunk_attn=chunk)
    want = int(visible(Sq, Skv, device="cpu", **masks).sum())
    assert visible_pairs(Sq, Skv, **masks) == want


def test_visible_pairs_of_the_served_prefills():
    """The counts behind the bounds of the three served prefill shapes:
    causal S = 1024 (InternLM2, and Llama-4-Scout, whose 8192-token chunks
    do not cut a 1024-token prompt) and RecurrentGemma's 2048 window over
    3072 tokens."""
    causal = visible_pairs(1024, 1024, causal=True, window=0, chunk_attn=0)
    assert causal == 1024 * 1025 // 2
    assert visible_pairs(1024, 1024, causal=True, window=0,
                         chunk_attn=8192) == causal
    assert visible_pairs(3072, 3072, causal=True, window=2048,
                         chunk_attn=0) == 4_195_328
