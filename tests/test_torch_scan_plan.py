"""The RG-LRU scan kernels' launch plan (``kernels/rglru_scan/kernel.py:
scan_plan``), on the CPU: which producer a shape takes, the ring's depth and
its shared memory.  The C side applies the same rule (``csrc/rglru_scan.cu:
make_plan``); its constants are read from the source here, and the card
tests hold the two plans, and the route each launch took, equal at every
tested shape."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.rglru_scan import kernel
from repro_torch.kernels.rglru_scan.kernel import scan_plan

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "csrc" / "rglru_scan.cu")
F32, BF16 = torch.float32, torch.bfloat16

# (B, S, R): RecurrentGemma-2B's train microbatch and served prefill, a
# ragged shape, and rows TMA cannot take (fp32 R 33: 132 bytes; bf16 R 100
# and 33: 200 and 66 bytes)
SHAPES = [(1, 4096, 2560), (4, 3072, 2560), (3, 1001, 1000), (2, 17, 33),
          (1, 512, 100), (2, 20, 64), (1, 1, 8), (1, 8192, 4096)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,S,R,dtype,want", [
    (1, 4096, 2560, F32, "tma"),        # train
    (1, 4096, 2560, BF16, "tma"),
    (4, 3072, 2560, F32, "tma"),        # served prefill
    (4, 3072, 2560, BF16, "tma"),
    (3, 1001, 1000, F32, "tma"),        # ragged: 4000-byte rows
    (3, 1001, 1000, BF16, "tma"),       # 2000-byte rows
    (2, 17, 33, F32, "cp_async"),       # 132-byte rows
    (2, 17, 33, BF16, "cp_async"),      # 66
    (1, 512, 100, BF16, "cp_async"),    # 200
    (1, 512, 100, F32, "tma"),          # 400
    (1, 1, 8, BF16, "tma"),             # 16
    (1, 1, 4, BF16, "cp_async"),        # 8
])
def test_scan_plan_route_follows_the_16_byte_row_rule(B, S, R, dtype, want,
                                                      backward):
    plan = scan_plan(B, S, R, dtype, backward)
    assert plan.route == want
    assert (R * torch.empty((), dtype=dtype).element_size()) % 16 == 0 \
        or plan.route == "cp_async"


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,S,R", SHAPES)
def test_scan_plan_unaligned_base_takes_cp_async(B, S, R, backward):
    for dtype in (F32, BF16):
        assert scan_plan(B, S, R, dtype, backward,
                         aligned=False).route == "cp_async"


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,S,R", SHAPES)
def test_scan_plan_fits_shared_memory(B, S, R, backward, aligned):
    for dtype in (F32, BF16):
        plan = scan_plan(B, S, R, dtype, backward, aligned)
        assert 0 < plan.smem_bytes <= kernel.SMEM_LIMIT


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,S,R", SHAPES)
def test_scan_plan_ring_reaches_its_depth(B, S, R, backward):
    """T x D >= min(S, DEPTH): the ring holds the stated number of steps
    ahead, or the whole sequence, and never more stages than tiles."""
    for dtype in (F32, BF16):
        for aligned in (True, False):
            plan = scan_plan(B, S, R, dtype, backward, aligned)
            tiles = -(-S // plan.t)
            assert plan.t * plan.d >= min(S, kernel.DEPTH[backward])
            assert 1 <= plan.d <= tiles
            assert (plan.ch, plan.t) == (kernel.CH, kernel.T[plan.route])
            assert plan.blocks == B * -(-R // plan.ch)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("S", [1, 7, 31, 32, 33, 64, 65, 100, 200, 4096])
def test_scan_plan_short_sequences(S, backward):
    """S = 1 and S shorter than one tile take one stage; longer S one stage
    a tile up to the depth, on either route."""
    for R, route in ((64, "tma"), (33, "cp_async")):
        plan = scan_plan(2, S, R, F32, backward)
        assert plan.route == route
        t = kernel.T[route]
        assert plan.t == t
        assert plan.d == min(-(-S // t), -(-kernel.DEPTH[backward] // t))


@pytest.mark.parametrize("B,S,R,dtype,backward,aligned,want", [
    # TMA: 128 slack + 128 barriers + D stages of 64-step tiles + two
    # staging tiles of every output
    (1, 4096, 2560, F32, False, True, 128 + 128 + 4 * 2 * 8192 + 2 * 8192),
    (1, 4096, 2560, F32, True, True,
     128 + 128 + 3 * 3 * 8192 + 2 * 2 * 8192),
    (4, 3072, 2560, BF16, False, True, 128 + 128 + 4 * 2 * 4096 + 2 * 8192),
    (4, 3072, 2560, BF16, True, True,
     128 + 128 + 3 * (4096 + 2 * 8192) + 2 * 2 * 4096),
    # S shorter than one tile: one stage, staging tiles still 64 steps
    (2, 20, 64, F32, False, True, 128 + 128 + 2 * 8192 + 2 * 8192),
    (2, 20, 64, BF16, True, True,
     128 + 128 + (4096 + 2 * 8192) + 2 * 2 * 4096),
    # cp.async: 32-step tiles, rows one word wider (68 bytes in bf16, 132
    # in fp32), no staging
    (2, 4096, 100, BF16, False, True, 128 + 128 + 8 * 2 * 2176),
    (2, 4096, 33, F32, True, True, 128 + 128 + 6 * 3 * 4224),
    (1, 4096, 2560, F32, True, False, 128 + 128 + 6 * 3 * 4224),
])
def test_scan_plan_shared_bytes(B, S, R, dtype, backward, aligned, want):
    assert scan_plan(B, S, R, dtype, backward, aligned).smem_bytes == want


def test_scan_plan_constants_match_the_cuda_source():
    """The constants the C side builds with are the Python plan's."""
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kCH"]) == kernel.CH
    assert int(consts["kStepsTma"]) == kernel.T["tma"]
    assert int(consts["kStepsCp"]) == kernel.T["cp_async"]
    assert int(consts["kDepthFwd"]) == kernel.DEPTH[False]
    assert int(consts["kDepthBwd"]) == kernel.DEPTH[True]
    assert int(consts["kStaging"]) == 2


@pytest.mark.parametrize("args,exc", [
    ((1, 16, 32, torch.float16, False), TypeError),
    ((1, 0, 32, F32, False), ValueError),
    ((0, 16, 32, F32, True), ValueError),
])
def test_scan_plan_refuses_what_no_kernel_takes(args, exc):
    with pytest.raises(exc):
        scan_plan(*args)
