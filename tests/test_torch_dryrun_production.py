"""Production cells of the port's dry run (``launch/dryrun.py``) at full
width on fake worlds of 256 and 512 ranks, one cell for each fault the
port's sharded model had before the dry run could run:

  * uneven head shards: tinyllama-1.1b's 4 kv heads on a 'model' axis of
    16 (``prefill_32k``), internvl2-1b's 14 query heads (``train_4k``);
  * decode under a mesh: tinyllama-1.1b ``decode_32k`` (the head dim of
    its cache sharded), mixtral-8x7b ``long_500k`` (B = 1, its ring
    cache's sequence sharded over 'data'), zamba2-1.2b ``decode_32k``
    (ssm states and the shared block's cache);
  * the expert-parallel MoE's train step: deepseek-moe-16b ``train_4k``.

They are counted at reduced depth (2 layers; zamba2 at 6, one segment and
its shared block), on the single-pod mesh, and the decode cells and one
prefill on the multi-pod mesh too (a multi-pod train step takes minutes on
a CPU: DTensor's redistribution planner searches the (pod, data) batch
layouts).  Every row is ``ok``; the batch-sharded decode cells do half the
flops per device on 512 ranks that they do on 256, and the B = 1 cell the
same.
"""
import concurrent.futures
import multiprocessing

import pytest

import test_torch_dist_ranks as ranks
from repro_torch.core.energy_model import calibrate

SINGLE = [("tinyllama-1.1b", "decode_32k", 2),
          ("tinyllama-1.1b", "prefill_32k", 2),
          ("internvl2-1b", "train_4k", 2),
          ("mixtral-8x7b", "long_500k", 2),
          ("deepseek-moe-16b", "train_4k", 2),
          ("zamba2-1.2b", "decode_32k", 6)]
MULTI = [("tinyllama-1.1b", "decode_32k", 2),
         ("tinyllama-1.1b", "prefill_32k", 2),
         ("mixtral-8x7b", "long_500k", 2),
         ("zamba2-1.2b", "decode_32k", 6)]


@pytest.fixture(scope="module")
def rows():
    tech = calibrate(device="cpu")
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=ctx, max_tasks_per_child=1) as pool:
        single = pool.submit(ranks.fake_production_rows, 256, SINGLE,
                             tech.values)
        multi = pool.submit(ranks.fake_production_rows, 512, MULTI,
                            tech.values)
        return {256: single.result(timeout=400),
                512: multi.result(timeout=400)}


@pytest.mark.parametrize("ranks_,cell", [(256, c) for c in SINGLE]
                         + [(512, c) for c in MULTI])
def test_production_cell_runs(rows, ranks_, cell):
    arch, shape, layers = cell
    row = rows[ranks_][f"{arch}|{shape}"]
    assert row["status"] == "ok"
    assert row["chips"] == ranks_
    assert row["mesh"] == {256: "pod16x16", 512: "pod2x16x16"}[ranks_]
    assert row["counted_depths"] == [layers]
    assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
    assert row["collective_bytes_per_device"] > 0
    assert 0 < row["roofline_fraction"] < 1
    if row["kind"] == "decode":  # the cache is donated
        assert row["memory"]["alias_size_in_bytes"] > 0


def test_batch_sharded_decode_halves_on_two_pods(rows):
    for arch in ("tinyllama-1.1b", "zamba2-1.2b"):
        one = rows[256][f"{arch}|decode_32k"]["flops_per_device"]
        two = rows[512][f"{arch}|decode_32k"]["flops_per_device"]
        assert two * 2 == one, arch
    key = "mixtral-8x7b|long_500k"  # B = 1: the pods replicate it
    assert rows[512][key]["flops_per_device"] == \
        rows[256][key]["flops_per_device"]
