"""K5/K6's host planner on the CPU (no JAX, no card).

``plan_scan`` picks how the scan kernel (``csrc/ssm_scan.cu``) runs one
call: N = 8 and 16 take the lanes kernel, N/4 lanes a (b, d) row and blocks
of 128 threads, narrowed to one warp while the grid has fewer blocks than
the card has SMs; the grid runs over (d-blocks, batches), so no block
straddles two batches.  Any other N takes the scalar kernel.
"""
import pytest

from repro_torch.configs.base import get_config
from repro_torch.kernels.ssm_scan import (LANE_N, SCAN_MIN_THREADS,
                                          SCAN_THREADS, ScanPlan, plan_scan)

H100_SMS = 132


def _reduced_shape(arch, B=2, S=16):
    cfg = get_config(arch).reduced()
    return (B, S, cfg.ssm_expand * cfg.d_model, cfg.ssm_state)


def test_plan_at_falcon_mamba_layer0():
    plan = plan_scan((2, 256, 8192, 16), H100_SMS)
    assert plan == ScanPlan("lanes", 4, 32, (256, 2))
    assert plan.blocks == 512 >= H100_SMS


def test_plan_at_benchgen_scan_spec():
    # 256 rows of 4 lanes are 32 warps: one-warp blocks, as many as there are
    plan = plan_scan((1, 128, 256, 16), H100_SMS)
    assert plan == ScanPlan("lanes", 4, 8, (32, 1))


def test_plan_at_the_reduced_configs_n8():
    shape = _reduced_shape("falcon-mamba-7b")
    assert shape[3] == 8
    plan = plan_scan(shape, H100_SMS)
    assert plan == ScanPlan("lanes", 2, 16, (8, 2))


def test_plan_on_a_ragged_d_has_a_partial_last_block():
    plan = plan_scan((3, 64, 201, 16), H100_SMS)
    assert plan == ScanPlan("lanes", 4, 8, (26, 3))
    assert 25 * plan.rows < 201 < 26 * plan.rows
    plan = plan_scan((2, 70, 4100, 16), H100_SMS)
    assert plan == ScanPlan("lanes", 4, 32, (129, 2))


def test_plan_other_n_takes_the_scalar_kernel():
    assert plan_scan((1, 32, 40, 5), H100_SMS) == \
        ScanPlan("any", 1, 128, (1, 1))
    assert plan_scan((3, 8, 300, 12), H100_SMS) == \
        ScanPlan("any", 1, 128, (8, 1))


@pytest.mark.parametrize("B", [1, 2, 3, 8])
@pytest.mark.parametrize("D", [1, 7, 40, 136, 200, 201, 256, 1000, 4100,
                               8192, 16384])
@pytest.mark.parametrize("N", LANE_N)
def test_plan_keeps_blocks_in_one_batch_and_fills_the_card(B, D, N):
    plan = plan_scan((B, 64, D, N), H100_SMS)
    lanes, rows = plan.lanes, plan.rows
    threads = lanes * rows
    assert plan.kernel == "lanes" and lanes == N // 4
    assert SCAN_MIN_THREADS <= threads <= SCAN_THREADS
    assert threads % 32 == 0
    # the grid's y is the batch: every block's rows lie in one batch
    d_blocks, batches = plan.grid
    assert batches == B
    assert (d_blocks - 1) * rows < D <= d_blocks * rows
    # at least one block per SM wherever one-warp blocks would give that;
    # otherwise the narrowest blocks
    if B * -(-D * lanes // 32) >= H100_SMS:
        assert plan.blocks >= H100_SMS
    else:
        assert threads == SCAN_MIN_THREADS
    # the widest blocks that do so
    if threads < SCAN_THREADS:
        assert B * -(-D // (2 * rows)) < H100_SMS


def test_plan_does_not_depend_on_s():
    assert len({plan_scan((2, s, 8192, 16), H100_SMS)
                for s in (0, 1, 5, 64, 256, 4096)}) == 1


@pytest.mark.parametrize("shape", [(0, 4, 8, 16), (1, 4, 0, 16),
                                   (1, -1, 8, 16), (65536, 1, 8, 16)])
def test_plan_refuses_what_the_grid_cannot_take(shape):
    with pytest.raises(ValueError):
        plan_scan(shape, H100_SMS)
